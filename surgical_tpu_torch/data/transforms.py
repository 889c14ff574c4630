"""Clip-synchronized augmentation on the device.

Port of ``surgical_tpu/data/transforms.py``. Parameters are drawn once per
image (a seq_len=1 clip) from an explicit ``torch.Generator`` and applied to
the image, its segmap and its flow alike, which reproduces the reference's
synchronized transforms (data_process.py:53-186) without shared RNG state.

Reference stacks (train_evp.py:147-183), on frames that arrive at
``AugConfig.resize`` (the wire format's size):
- train: RandomCrop(224) -> ColorJitter(0.1, 0.1, 0.1, 0.05) ->
         RandomHorizontalFlip -> RandomRotation(+-5 deg) -> Normalize
- eval:  CenterCrop(224) -> Normalize

Flow gets the geometry only: the horizontal flip negates u, the rotation
rotates the (u, v) vectors. Colour jitter applies to images only. The
rotation is nearest-neighbour with zero fill (torchvision's defaults), done
as one index gather through static per-angle tables. Unlike the JAX package
(which casts flow to the image dtype for its one gather over all channels),
flow is rotated at its own dtype.

The JAX stacks also resize frames of another size with ``jax.image.resize``;
the port takes frames at ``resize`` only and raises otherwise (ROADMAP
Queue 3).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from surgical_tpu_torch.core.config import CHOLEC80_MEAN, CHOLEC80_STD


@dataclass(frozen=True)
class AugConfig:
    resize: int = 250
    crop: int = 224
    degrees: float = 5.0
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.05
    flip_prob: float = 0.5


class AugParams(NamedTuple):
    """Per-image parameters, each with a leading batch axis."""

    crop_xy: torch.Tensor  # [B, 2] int (x1, y1)
    flip: torch.Tensor  # [B] bool
    angle_deg: torch.Tensor  # [B] float, integer-valued
    brightness: torch.Tensor  # [B]
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


def draw_params(generator: torch.Generator, cfg: AugConfig, batch: int) -> AugParams:
    """One parameter set per image, drawn on the generator's device."""
    dev = generator.device
    span = cfg.resize - cfg.crop
    deg = int(cfg.degrees)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev)
    return AugParams(
        crop_xy=torch.randint(0, span + 1, (batch, 2), generator=generator, device=dev),
        flip=torch.rand(batch, generator=generator, device=dev) < cfg.flip_prob,
        angle_deg=torch.randint(-deg, deg + 1, (batch,), generator=generator,
                                device=dev).float(),
        brightness=u(1 - cfg.brightness, 1 + cfg.brightness),
        contrast=u(1 - cfg.contrast, 1 + cfg.contrast),
        saturation=u(1 - cfg.saturation, 1 + cfg.saturation),
        hue=u(-cfg.hue, cfg.hue),
    )


# -- geometry -----------------------------------------------------------------

def _check_size(x, cfg: AugConfig) -> None:
    if x.shape[1] != cfg.resize or x.shape[2] != cfg.resize:
        raise ValueError(f"frames must arrive at the wire size {cfg.resize}x{cfg.resize}, got "
                         f"{tuple(x.shape[1:3])} (resizing here is not ported: ROADMAP Queue 3)")


def crop(x, xy, size: int):
    """Per-image (x1, y1) crop of [B, H, W, C] as one gather; xy [B, 2]."""
    B = x.shape[0]
    ar = torch.arange(size, device=x.device)
    rows = (xy[:, 1, None] + ar)[:, :, None]
    cols = (xy[:, 0, None] + ar)[:, None, :]
    return x[torch.arange(B, device=x.device)[:, None, None], rows, cols]


def center_crop(x, size: int):
    H, W = x.shape[1:3]
    y0, x0 = (H - size) // 2, (W - size) // 2
    return x[:, y0:y0 + size, x0:x0 + size, :]


def hflip(x, flip, negate_u: bool = False):
    """Mirror the images whose ``flip`` [B] is set (flow: u negated)."""
    flipped = x.flip(2)
    if negate_u:
        flipped = torch.cat([-flipped[..., :1], flipped[..., 1:]], dim=-1)
    return torch.where(flip[:, None, None, None], flipped, x)


# -- colour (torchvision formulas), fp32 ------------------------------------

_GRAY = (0.299, 0.587, 0.114)


def _gray(img):
    return img @ torch.tensor(_GRAY, dtype=img.dtype, device=img.device)


def _per_image(f, img):
    return f.reshape((-1,) + (1,) * (img.dim() - 1))


def adjust_brightness(img, f):
    return torch.clamp(img * _per_image(f, img), 0.0, 1.0)


def adjust_contrast(img, f):
    mean = _gray(img).mean(dim=(-2, -1))
    f = _per_image(f, img)
    return torch.clamp(f * img + (1 - f) * _per_image(mean, img), 0.0, 1.0)


def adjust_saturation(img, f):
    f = _per_image(f, img)
    return torch.clamp(f * img + (1 - f) * _gray(img)[..., None], 0.0, 1.0)


def adjust_hue(img, shift):
    """Hue rotation in HSV space, ``shift`` [B] in turns (torchvision)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    v = maxc
    d = maxc - minc
    s = torch.where(maxc > 0, d / torch.clamp(maxc, min=1e-12), torch.zeros_like(d))
    dn = torch.clamp(d, min=1e-12)
    rc, gc, bc = (maxc - r) / dn, (maxc - g) / dn, (maxc - b) / dn
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(d == 0, torch.zeros_like(h), h)
    h = torch.remainder(h + shift.reshape((-1,) + (1,) * (h.dim() - 1)), 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *c: torch.gather(torch.stack(c, dim=-1), -1, i)[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def color_jitter(img, p: AugParams):
    """Brightness, contrast, saturation, hue in fp32; returns fp32."""
    img = adjust_brightness(img.float(), p.brightness)
    img = adjust_contrast(img, p.contrast)
    img = adjust_saturation(img, p.saturation)
    return adjust_hue(img, p.hue)


def normalize(img):
    """(img - mean) / std in fp32, written back at the input dtype."""
    mean = torch.tensor(CHOLEC80_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(CHOLEC80_STD, dtype=torch.float32, device=img.device)
    return ((img.float() - mean) / std).to(img.dtype)


# -- rotation -----------------------------------------------------------------

def _rotation_tables(size: int, degrees: int) -> np.ndarray:
    """Static nearest-neighbour rotation index tables for every integer
    angle in [-degrees, degrees]: [A, size*size]. Out-of-frame destinations
    point at index size*size, a zero pixel the rotation appends, so the
    gather itself zero-fills."""
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
                         indexing="ij")
    c = (size - 1) / 2.0
    tables = []
    for a in range(-degrees, degrees + 1):
        r = np.deg2rad(a)
        xs = np.round((xx - c) * np.cos(r) + (yy - c) * np.sin(r) + c).astype(np.int32)
        ys = np.round(-(xx - c) * np.sin(r) + (yy - c) * np.cos(r) + c).astype(np.int32)
        v = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        flat = np.clip(ys, 0, size - 1) * size + np.clip(xs, 0, size - 1)
        tables.append(np.where(v, flat, size * size).reshape(-1))
    return np.stack(tables)


@functools.lru_cache(maxsize=None)
def _device_tables(size: int, degrees: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rotation_tables(size, degrees)).long().to(device)


def _rotate_flow_vectors(f, angle_idx, degrees: int):
    """Rotate the (u, v) flow values by each image's angle, in fp32,
    rounded to f's dtype (the spatial move is the shared gather)."""
    rad = (angle_idx.float() - degrees) * (math.pi / 180.0)
    cos = torch.cos(rad)[:, None, None]
    sin = torch.sin(rad)[:, None, None]
    u, v = f[..., 0].float(), f[..., 1].float()
    return torch.stack([u * cos - v * sin, u * sin + v * cos], -1).to(f.dtype)


def batched_rotate_nearest(x, angle_idx, degrees: int, rotate_vectors: bool = False):
    """Per-image integer-angle rotation of [B, S, S, C] as one gather through
    the tables; ``angle_idx`` [B] in [0, 2 * degrees]."""
    B, S = x.shape[0], x.shape[1]
    idx = _device_tables(S, degrees, x.device)[angle_idx.long()]  # [B, S*S]
    xf = x.reshape(B, S * S, -1)
    xf = torch.cat([xf, xf.new_zeros(B, 1, xf.shape[-1])], dim=1)
    out = torch.gather(xf, 1, idx[:, :, None].expand(-1, -1, xf.shape[-1])).reshape(x.shape)
    if rotate_vectors:
        out = _rotate_flow_vectors(out, angle_idx, degrees)
    return out


# -- full stacks ----------------------------------------------------------------

def train_preprocess_batch(images, segmaps, flow, generator: torch.Generator | None = None,
                           cfg: AugConfig = AugConfig(), params: AugParams | None = None):
    """The train stack over a batch of seq_len=1 clips [B, r, r, C] (float in
    [0, 1]; flow [B, r, r, 2] or None), per-image parameters drawn from
    ``generator`` unless ``params`` are given. Geometry is data movement,
    exact at any dtype; colour runs in fp32 and is written back at the input
    dtype. Returns (images, segmaps, flow) at ``cfg.crop``."""
    _check_size(images, cfg)
    _check_size(segmaps, cfg)
    if params is None:
        params = draw_params(generator, cfg, images.shape[0])
    dev = images.device
    p = AugParams(*(t.to(dev) for t in params))
    img = crop(images, p.crop_xy, cfg.crop)
    seg = crop(segmaps, p.crop_xy, cfg.crop)
    img = color_jitter(img, p).to(images.dtype)
    img, seg = hflip(img, p.flip), hflip(seg, p.flip)
    deg = int(cfg.degrees)
    angle_idx = p.angle_deg.long() + deg
    img = batched_rotate_nearest(img, angle_idx, deg)
    seg = batched_rotate_nearest(seg, angle_idx, deg)
    fl = None
    if flow is not None:
        _check_size(flow, cfg)
        fl = hflip(crop(flow, p.crop_xy, cfg.crop), p.flip, negate_u=True)
        fl = batched_rotate_nearest(fl, angle_idx, deg, rotate_vectors=True)
    return normalize(img), normalize(seg), fl


def eval_preprocess_clip(images, segmaps, flow, cfg: AugConfig = AugConfig()):
    """CenterCrop -> Normalize (train_evp.py:173-177); flow centre-cropped."""
    _check_size(images, cfg)
    _check_size(segmaps, cfg)
    images = normalize(center_crop(images, cfg.crop))
    segmaps = normalize(center_crop(segmaps, cfg.crop))
    if flow is not None:
        flow = center_crop(flow, cfg.crop)
    return images, segmaps, flow
