"""LFB feature extraction: wire-format frames -> 2048-d features -> store.

Port of ``surgical_tpu/train/extract.py`` (``wire_dequant``,
``make_raw_feature_fn``, ``extract_features``, ``extract_to_store``). Batches
arrive in the wire format (uint8 RGB frames, uint8 single-channel segmaps,
float16 flow); dequantization and normalization run on the device, and
features leave it in float16 (the reference's fp16-autocast precision).

While the device computes batch i+1, batch i's features copy to pinned host
memory on a side stream; the host waits on that copy only when it writes the
features out. Each batch runs at its true size: there is no compile to
amortize, so the ragged tail is not padded.
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


def make_raw_feature_fn(model, d2h_dtype=torch.float16):
    """Feature extractor over wire-format host batches (numpy or tensors):
    fn(img_u8, seg_u8, flow_f16 | None) -> [B, E] features in ``d2h_dtype``
    on the model's device."""
    device = next(model.parameters()).device
    dequant = wire_dequant(device)

    def to_dev(a):
        return torch.as_tensor(a).to(device, non_blocking=True)

    @torch.no_grad()
    def feature_fn(img_u8, seg_u8, flow_f16):
        img, seg = dequant(to_dev(img_u8), to_dev(seg_u8))
        flow = None if flow_f16 is None else to_dev(flow_f16).to(torch.bfloat16)
        return fused_forward(model, img, seg, flow, return_features=True).to(d2h_dtype)

    return feature_fn


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
    ``batch_size`` frames; returns ([N, D] float32 features, timing stats)."""
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
        feats = feature_fn(*batch)
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
