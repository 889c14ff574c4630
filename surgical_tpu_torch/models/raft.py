"""RAFT optical flow, inference only, in the upstream ``raft-things.pth`` layout.

Port of ``surgical_tpu/models/raft.py`` (Teed & Deng, ECCV'20) as NCHW
``nn.Module``s whose state-dict names are the upstream checkpoint's, so
``RAFT.load_state_dict(sd, strict=True)`` takes an upstream dict unchanged
(``models/convert.py::load_torch_pth`` strips the DataParallel ``module.``
prefix; JAX parameter trees come through ``export_raft_state_dict``):

- feature encoder (``fnet``): 2-blocks-per-layer residual CNN -> 256-d at
  1/8 resolution, non-affine instance norm, both frames through shared
  weights;
- context encoder (``cnet``): the same trunk with BatchNorm from its
  running statistics (the module is never put in train mode) -> 128 tanh
  "net" + 128 relu "inp";
- all-pairs correlation as one [N, N] matmul, then an average-pooled
  pyramid of ``corr_levels`` levels;
- per iteration, a (2r+1)^2 window around the current flow in every level
  (``lookup_pyramid``: two batched contractions against tent weights per
  level; ``lookup_pyramid_gather`` is the four-corner gather oracle); the
  window's channels enumerate the x offset outer, as upstream's
  ``meshgrid(dy, dx)`` does, so the motion encoder's weights line up;
- separable (1x5 then 5x1) ConvGRU, flow head and convex 8x upsampling
  (mask channels 9-outer: ``view(N, 1, 9, 8, 8, H, W)``).

Precision policy: RAFT runs in fp32 with TF32 off for cuDNN convolutions and
for matmuls inside its forward (the flags are restored on exit), as upstream
RAFT's default ``mixed_precision=False`` and the JAX model compute it. Its
convolutions run in cuDNN's benchmark mode (``autotuned_convolutions``): the
first call at each shape times the algorithms.

A batch of frame pairs per call: ``RAFT()(image1, image2)`` takes [B, H, W, 3]
tensors in [-1, 1] (or one [H, W, 3] pair) with H and W multiples of 8 and
returns the flows [B, H, W, 2] (or [H, W, 2]). Both frames of every pair go
through the feature encoder as one batch of 2B, the first frames through the
context encoder as one of B; instance norm and the eval-mode BatchNorm act per
sample, so a pair's flow does not depend on the batch around it beyond
round-off. Where a pyramid level has an odd side, ``F.avg_pool2d`` floors it as
upstream does (the JAX module reshapes by halves and runs only on even sides,
where the two agree).

Spans (``utils/trace.py``): ``flow.encode`` (both encoders, the volume and the
pyramid), ``flow.lookup`` and ``flow.update`` once each per iteration,
``flow.upsample``; ``make_flow_fn``'s ``flow.h2d``, ``flow.forward`` and
``flow.drain``. ``COUNTS`` (``counters()["raft"]``): the forward's batches,
pairs and iterations, and the largest batch.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.utils.trace import span

COUNTS = {"batches": 0, "pairs": 0, "iterations": 0, "largest_batch": 0}


@contextlib.contextmanager
def fp32_precision():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions inside the block,
    the previous flags restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def autotuned_convolutions():
    """cuDNN's benchmark mode inside the block, the previous flag restored
    after it: each convolution shape's algorithm is timed at its first call
    and reused. On the H100 at B = 32 and 256 px, cuDNN's heuristics alone
    gave the motion encoder's 256 -> 126-channel 3x3 convolution an FFT
    algorithm at ~35 ms per call, half of each 20-iteration batch, which took
    390-700 ms against 207-218 ms autotuned."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def _norm(kind: str, channels: int) -> nn.Module:
    """Non-affine instance norm (biased variance, eps 1e-5) or BatchNorm."""
    return nn.InstanceNorm2d(channels) if kind == "instance" else nn.BatchNorm2d(channels)


def _fold_norm3(module, state_dict, prefix, *_):
    """Upstream registers a strided unit's downsample norm twice, as
    ``norm3`` and as ``downsample.1``, so its state dict holds both copies of
    one module; the port registers it once, as ``downsample.1``. A
    ``norm3`` entry is dropped after checking that it equals its twin (or
    becomes the twin where the twin is absent)."""
    head = prefix + "norm3."
    for key in [k for k in state_dict if k.startswith(head)]:
        twin = prefix + "downsample.1." + key[len(head):]
        value = state_dict.pop(key)
        if twin not in state_dict:
            state_dict[twin] = value
        elif not torch.equal(torch.as_tensor(value), torch.as_tensor(state_dict[twin])):
            raise ValueError(f"{key} differs from {twin}: they are one module upstream")


class ResidualUnit(nn.Module):
    """Upstream ResidualBlock: two conv+norm+relu, a 1x1 strided downsample
    (``downsample.0`` conv, ``downsample.1`` norm) where the stride is 2."""

    def __init__(self, cin: int, cout: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = _norm(norm, cout), _norm(norm, cout)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride),
                                         _norm(norm, cout))
                           if stride != 1 or cin != cout else None)
        self.register_load_state_dict_pre_hook(_fold_norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """1/8-resolution trunk (upstream BasicEncoder): conv7x7/2, three
    2-unit residual layers (64, 96/2, 128/2), 1x1 projection."""

    def __init__(self, out_dim: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        self.layer1 = nn.Sequential(ResidualUnit(64, 64, norm), ResidualUnit(64, 64, norm))
        self.layer2 = nn.Sequential(ResidualUnit(64, 96, norm, 2), ResidualUnit(96, 96, norm))
        self.layer3 = nn.Sequential(ResidualUnit(96, 128, norm, 2),
                                    ResidualUnit(128, 128, norm))
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """f1, f2: [..., C, H, W] -> corr [..., H*W, H, W], normalized by
    sqrt(C): one product per pair."""
    *lead, C, H, W = f1.shape
    a, b = f1.reshape(*lead, C, H * W), f2.reshape(*lead, C, H * W)
    corr = a.transpose(-1, -2) @ b / np.sqrt(C)
    return corr.reshape(*lead, H * W, H, W)


def corr_pyramid(corr: torch.Tensor, levels: int = 4) -> list[torch.Tensor]:
    """Average-pool the last two dims by 2 into a pyramid of up to
    ``levels`` levels, stopping when a side is below 2."""
    pyr = [corr]
    for _ in range(levels - 1):
        c = pyr[-1]
        if c.shape[-2] < 2 or c.shape[-1] < 2:
            break  # feature grid too small for more levels
        pyr.append(F.avg_pool2d(c, 2, stride=2))
    return pyr


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img: [H, W]; coords: [..., 2] (x, y) -> [...] (zero padding)."""
    H, W = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = x.floor(), y.floor()
    dx, dy = x - x0, y - y0

    def gather(xi, yi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return torch.where(valid, v, torch.zeros_like(v))

    return (gather(x0, y0) * (1 - dx) * (1 - dy) + gather(x0 + 1, y0) * dx * (1 - dy)
            + gather(x0, y0 + 1) * (1 - dx) * dy + gather(x0 + 1, y0 + 1) * dx * dy)


def _centers(flow: torch.Tensor):
    """flow [..., 2, H, W] -> the sampling centers' x and y, each [..., H*W]."""
    *lead, _, H, W = flow.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                            torch.arange(W, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    return ((xx + flow[..., 0, :, :]).reshape(*lead, H * W),
            (yy + flow[..., 1, :, :]).reshape(*lead, H * W))


def lookup_pyramid(pyr: list[torch.Tensor], flow: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """Sample a (2r+1)^2 window around (grid + flow) in every level, as two
    batched contractions against tent weights per level.

    flow: [..., 2, H, W] at 1/8 resolution, pyr's levels [..., H*W, h, w].
    Returns [..., levels * (2r+1)^2, H, W].

    Bilinear sampling with zero padding at a fractional coordinate c is a
    contraction against the tent weights relu(1 - |i - c|) over the source
    axis (two nonzeros in range, none out of range: the zero fill), and the
    window's integer offsets shift the centers, so per level

        tmp[n, ky, w] = sum_h wy[n, ky, h] corr[n, h, w]
        out[n, ky, kx] = sum_w tmp[n, ky, w] wx[n, kx, w]

    Channel k = i*(2r+1) + j samples the offset (dx = i - r, dy = j - r):
    the x offset is the outer index (upstream's ``meshgrid(dy, dx)``).
    """
    *lead, _, H, W = flow.shape
    N, K = H * W, 2 * radius + 1
    cx, cy = _centers(flow)
    d = torch.arange(-radius, radius + 1, dtype=flow.dtype, device=flow.device)
    out = []
    for lvl, corr in enumerate(pyr):
        scale = 2.0 ** lvl
        h, w = corr.shape[-2:]
        ys = cy[..., None, None] / scale + d[:, None]  # [..., N, K, 1]
        xs = cx[..., None, None] / scale + d[:, None]
        wy = (1 - (torch.arange(h, dtype=flow.dtype, device=flow.device) - ys).abs()).clamp_min(0)
        wx = (1 - (torch.arange(w, dtype=flow.dtype, device=flow.device) - xs).abs()).clamp_min(0)
        smp = wy @ corr @ wx.transpose(-1, -2)                       # [..., N, ky, kx]
        out.append(smp.transpose(-1, -2).reshape(*lead, N, K * K))  # x offset outer
    return torch.cat(out, -1).transpose(-1, -2).reshape(*lead, -1, H, W)


def lookup_pyramid_gather(pyr: list[torch.Tensor], flow: torch.Tensor,
                          radius: int = 4) -> torch.Tensor:
    """The four-corner bilinear gather lookup: the semantics oracle of
    ``lookup_pyramid`` (same arguments, same result)."""
    *lead, _, H, W = flow.shape
    N = H * W
    cx, cy = _centers(flow)
    vals = torch.arange(-radius, radius + 1, dtype=flow.dtype, device=flow.device)
    dxs, dys = (g.reshape(-1) for g in torch.meshgrid(vals, vals, indexing="ij"))
    out = []
    for lvl, corr in enumerate(pyr):
        scale = 2.0 ** lvl
        h, w = corr.shape[-2:]
        x = cx[..., None] / scale + dxs  # [..., N, K^2], dx outer
        y = cy[..., None] / scale + dys
        x0, y0 = x.floor(), y.floor()
        fx, fy = x - x0, y - y0
        flat = corr.reshape(*lead, N, h * w)

        def gather(xi, yi):
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
            v = torch.gather(flat, -1, idx)
            return torch.where(valid, v, torch.zeros_like(v))

        out.append(gather(x0, y0) * (1 - fx) * (1 - fy) + gather(x0 + 1, y0) * fx * (1 - fy)
                   + gather(x0, y0 + 1) * (1 - fx) * fy + gather(x0 + 1, y0 + 1) * fx * fy)
    return torch.cat(out, -1).transpose(-1, -2).reshape(*lead, -1, H, W)


class SepConvGRU(nn.Module):
    """Separable ConvGRU: a 1x5 pass (``conv{z,r,q}1``) then a 5x1 pass
    (``conv{z,r,q}2``)."""

    def __init__(self, hidden: int = 128, inputs: int = 256):
        super().__init__()
        for i, (ks, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), start=1):
            for g in "zrq":
                setattr(self, f"conv{g}{i}", nn.Conv2d(hidden + inputs, hidden, ks, padding=pad))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(192 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        m = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([m, flow], 1)  # 128 channels


class FlowHead(nn.Module):
    def __init__(self, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = nn.Conv2d(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int = 128):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, hidden + 128)
        self.flow_head = FlowHead(hidden)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net), 0.25 * self.mask(net)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex-combination upsampling: flow [N, 2, H, W], mask
    [N, 576, H, W] -> [N, 2, 8H, 8W]. Mask channel c = k*64 + u*8 + v
    weighs 3x3 neighbour k (row-major) for subpixel (u, v)."""
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.reshape(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)  # [N, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """Frame pairs -> optical flow. Images [B, H, W, 3] (or one [H, W, 3]
    pair) in [-1, 1], H and W multiples of 8; returns [B, H, W, 2] (or
    [H, W, 2]) fp32. Seeded init: every conv's
    weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from ``seed``,
    BatchNorm at identity statistics; real weights come from
    ``load_state_dict``."""

    hidden = 128

    def __init__(self, iters: int = 20, corr_levels: int = 4, corr_radius: int = 4, *,
                 seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.fnet = Encoder(256, "instance")
        self.cnet = Encoder(2 * self.hidden, "batch")
        self.update_block = UpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, self.hidden)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    bound = m.weight[0].numel() ** -0.5
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.uniform_(-bound, bound, generator=g)
        self.eval()
        self.to(device)

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError("RAFT is inference-only here: its BatchNorm keeps the "
                               "imported running statistics")
        return super().train(False)

    @torch.no_grad()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        one = image1.dim() == 3
        if one:
            image1, image2 = image1[None], image2[None]
        B, H, W, C = image1.shape
        if H % 8 or W % 8 or C != 3 or image2.shape != image1.shape:
            raise ValueError(f"RAFT takes two [H, W, 3] frames with H, W multiples of 8: "
                             f"{tuple(image1.shape)}, {tuple(image2.shape)}")
        with fp32_precision(), autotuned_convolutions():
            with span("flow.encode"):
                x = torch.cat([image1, image2]).float().permute(0, 3, 1, 2).contiguous()
                fmap = self.fnet(x)
                ctx = self.cnet(x[:B])
                net, inp = torch.tanh(ctx[:, :self.hidden]), F.relu(ctx[:, self.hidden:])
                pyr = corr_pyramid(all_pairs_correlation(fmap[:B], fmap[B:]), self.corr_levels)
                flow = x.new_zeros(B, 2, H // 8, W // 8)
                mask = x.new_zeros(B, 64 * 9, H // 8, W // 8)
            for _ in range(self.iters):
                with span("flow.lookup"):
                    corr = lookup_pyramid(pyr, flow, self.corr_radius)
                with span("flow.update"):
                    net, delta, mask = self.update_block(net, inp, corr, flow)
                    flow = flow + delta
            with span("flow.upsample"):
                up = convex_upsample(flow, mask).permute(0, 2, 3, 1)
        COUNTS["batches"] += 1
        COUNTS["pairs"] += B
        COUNTS["iterations"] += self.iters
        COUNTS["largest_batch"] = max(COUNTS["largest_batch"], B)
        return up[0] if one else up


def _edge_pad8(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> padded at the bottom and right to multiples of 8 by
    repeating the last row and column (``np.pad(mode="edge")``)."""
    H, W = x.shape[-3:-1]
    if not (H % 8 or W % 8):
        return x
    rows = torch.arange(H + (-H) % 8, device=x.device).clamp_max(H - 1)
    cols = torch.arange(W + (-W) % 8, device=x.device).clamp_max(W - 1)
    return x[..., rows[:, None], cols, :]


def make_flow_fn(model: RAFT):
    """The precompute driver's batched flow function for ``model``: frames
    [B, H, W, 3] (or one [H, W, 3] pair), uint8 host arrays as decoded
    (float32 in [0, 255] is taken too), go to the model's device as they
    are, are mapped to [-1, 1] there (x / 127.5 - 1) and edge-padded at the
    bottom and right to multiples of 8; the flows come back cropped to
    [B, H, W, 2] (or [H, W, 2]) float32 numpy."""
    device = next(model.parameters()).device

    def flow_fn(frames1, frames2) -> np.ndarray:
        with span("flow.h2d"):
            a, b = (torch.as_tensor(np.asarray(f)).to(device) for f in (frames1, frames2))
        with span("flow.forward"):
            H, W = a.shape[-3:-1]
            flow = model(*(_edge_pad8(t.float() / 127.5 - 1.0) for t in (a, b)))
            flow = flow[..., :H, :W, :]
        with span("flow.drain"):
            return flow.cpu().numpy()

    flow_fn.batched = True
    return flow_fn
