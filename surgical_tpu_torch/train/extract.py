"""LFB feature extraction: wire-format frames -> 2048-d features -> store.

Port of ``surgical_tpu/train/extract.py`` (``wire_dequant``,
``make_raw_feature_fn``, ``extract_features``, ``extract_to_store``). Batches
arrive in the wire format (uint8 RGB frames, uint8 single-channel segmaps,
float16 flow); dequantization and normalization run on the device, and
features leave it in float16 (the reference's fp16-autocast precision).

The backbone graph follows the JAX package's rule (``_use_fused_default``,
surgical_tpu/train/extract.py:52-65): on the card a preset-size backbone
runs the fused serving graph on the kernels and the ``tiny`` variant the
flax graph (``MiTEVP.graph_forward`` at bf16). On the CPU the port runs the
serving graph with the kernels' plain versions whatever the variant, where
JAX runs the flax graph.

While the device computes batch i+1, batch i's features copy to pinned host
memory on a side stream; the host waits on that copy only when it writes the
features out. A ragged last batch is zero-padded to ``batch_size``, as the
JAX package pads it: the batch size picks stage 4's route in
``fused_forward`` (whole-stage kernel at a multiple of 8), so the tail runs
the route the full batches run, as it does in JAX.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch

from surgical_tpu_torch.core.config import CHOLEC80_MEAN, CHOLEC80_STD
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.data.feature_store import FeatureStore
from surgical_tpu_torch.models.mit_fused import fused_forward


def wire_dequant(device=DEFAULT_DEVICE):
    """bf16 (x - mean) / std with the Cholec80 channel stats, segmap
    broadcast to 3 channels: fn(img_u8 [B,H,W,3], seg_u8 [B,H,W,1])."""
    device = resolve_device(device)
    mean = (torch.tensor(CHOLEC80_MEAN, dtype=torch.float32, device=device) * 255.0
            ).to(torch.bfloat16)
    inv_std = (1.0 / (torch.tensor(CHOLEC80_STD, dtype=torch.float32, device=device) * 255.0)
               ).to(torch.bfloat16)

    def dequant(img_u8, seg_u8):
        img = (img_u8.to(torch.bfloat16) - mean) * inv_std
        seg = (seg_u8.to(torch.bfloat16) - mean) * inv_std
        return img, seg.expand(img.shape)

    return dequant


def use_fused_default(cfg, device) -> bool:
    """The serving graph's route: the fused kernels for a preset-size
    backbone on the card, the flax graph for ``tiny`` there; the serving
    graph (the kernels' plain versions) on the CPU."""
    return torch.device(device).type == "cpu" or cfg.variant != "tiny"


def make_raw_feature_fn(model, d2h_dtype=torch.float16, use_fused=None):
    """Feature extractor over wire-format host batches (numpy or tensors):
    fn(img_u8, seg_u8, flow_f16 | None) -> [B, E] features in ``d2h_dtype``
    on the model's device. ``use_fused``: the fused serving graph (True) or
    the flax graph at bf16 (False); None takes ``use_fused_default``. The
    choice is ``fn.use_fused``."""
    device = next(model.parameters()).device
    dequant = wire_dequant(device)
    if use_fused is None:
        use_fused = use_fused_default(model.cfg, device)

    def to_dev(a):
        return torch.as_tensor(a).to(device, non_blocking=True)

    @torch.no_grad()
    def feature_fn(img_u8, seg_u8, flow_f16):
        img, seg = dequant(to_dev(img_u8), to_dev(seg_u8))
        flow = None if flow_f16 is None else to_dev(flow_f16).to(torch.bfloat16)
        if use_fused:
            feats = fused_forward(model, img, seg, flow, return_features=True)
        else:
            feats = model.graph_forward(img, seg, flow, return_features=True,
                                        dtype=torch.bfloat16)
        return feats.to(d2h_dtype)

    feature_fn.use_fused = use_fused
    return feature_fn


def _pad_batch(batch: tuple, size: int) -> tuple:
    """Zero-pad each array of a host batch (``None`` stays) along its leading
    axis to ``size`` frames (surgical_tpu/parallel/mesh.py::pad_batch)."""
    n = batch[0].shape[0]
    if n == size:
        return batch

    def pad(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a.new_zeros((size - n, *a.shape[1:]))])
        return np.pad(a, [(0, size - n)] + [(0, 0)] * (a.ndim - 1))

    return tuple(None if a is None else pad(a) for a in batch)


def _start_copy(feats: torch.Tensor, stream):
    """Begin the device->host copy of ``feats``; returns (host tensor, event
    that marks the copy done, or None when nothing is in flight)."""
    if not feats.is_cuda:
        return feats, None
    host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
    stream.wait_stream(torch.cuda.current_stream(feats.device))
    with torch.cuda.stream(stream):
        host.copy_(feats, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    feats.record_stream(stream)
    return host, done


def extract_features(
    feature_fn: Callable,
    batches: Iterable[tuple],
    total_frames: int,
    feature_dim: int,
    batch_size: int,
) -> tuple[np.ndarray, dict]:
    """Run extraction over (images, segmaps, flow) host batches of at most
    ``batch_size`` frames, a shorter one padded to ``batch_size``; returns
    ([N, D] float32 features, timing stats)."""
    out = np.empty((total_frames, feature_dim), dtype=np.float32)
    stream = torch.cuda.Stream() if torch.cuda.is_available() else None
    pos = 0
    pending = None

    def drain(p):
        host, done, at, n = p
        if done is not None:
            done.synchronize()
        out[at:at + n] = host[:n].float().numpy()

    t0 = time.perf_counter()
    for batch in batches:
        n = batch[0].shape[0]
        if n > batch_size:
            raise ValueError(f"batch of {n} frames exceeds batch_size={batch_size}")
        feats = feature_fn(*_pad_batch(batch, batch_size))
        host, done = _start_copy(feats, stream)
        if pending is not None:
            drain(pending)
        pending = (host, done, pos, n)
        pos += n
    if pending is not None:
        drain(pending)
    dt = time.perf_counter() - t0
    if pos != total_frames:
        raise ValueError(f"batches held {pos} frames, expected {total_frames}")
    return out, {"frames": total_frames, "seconds": dt, "fps": total_frames / dt}


def extract_to_store(
    feature_fn,
    batches,
    lengths,
    feature_dim: int,
    batch_size: int,
    directory: str,
    meta: dict | None = None,
) -> tuple[FeatureStore, dict]:
    """Extract and publish the features as a FeatureStore."""
    total = int(np.sum(lengths))
    feats, stats = extract_features(feature_fn, batches, total, feature_dim, batch_size)
    store = FeatureStore.create(directory, feats, lengths, meta={**(meta or {}), **stats})
    return store, stats
