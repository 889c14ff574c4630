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
features out. On the card (one process, float weights) a batch of host
arrays is first copied into pinned memory (``PinnedStage``), on the host
while the card still runs the batch before, so that its trip to the card is
one DMA at the link's rate and not CUDA's pageable staging, which
holds the stream for the host's memcpy; and the forward is replayed as the
live session's CUDA graphs of the glue between the MiT kernel calls
(``ExtractGraph``, ``serving/feature_graph.py``), captured at the first
batch of a layout: the same operations, bit for bit, issued as a few graph
launches instead of ~900 operations (b0) a batch. A ragged last batch is
zero-padded to ``batch_size``, as the JAX package pads it: the batch size
picks stage 4's route in ``fused_forward`` (whole-stage kernel at a
multiple of 8), so the tail runs the route the full batches run, as it does
in JAX.

Over a process group (``make_raw_feature_fn(group=...)``, which
``extract-features`` passes as the default group under
``torch.distributed.run``; without one, each process extracts its own
batches alone) extraction is data-parallel, as JAX runs
the fused graph per chip under ``shard_map`` over its data mesh: every rank
takes the same padded batch, runs its contiguous B / world frames through
the graph and all-gathers the features in rank order. The route is decided
on each rank's B / world frames: stage 4 takes the stage kernel only where
(B / world) % 8 == 0. Only rank 0 writes the store.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from surgical_tpu_torch.core.config import CHOLEC80_MEAN, CHOLEC80_STD
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.data.feature_store import FeatureStore
from surgical_tpu_torch.models.mit_fused import fused_forward, kernel_weights
from surgical_tpu_torch.parallel import mesh
from surgical_tpu_torch.serving.feature_graph import FeatureGraph
from surgical_tpu_torch.serving.graphs import layout
from surgical_tpu_torch.serving.quant import dequantize_state, quantize_state
from surgical_tpu_torch.utils.trace import span


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


class WireForward(nn.Module):
    """The serving computation over wire-format batches, as one module:
    ``wire_dequant``, then the fused serving graph (``use_fused``) or the
    flax graph at bf16, cast to ``out_dtype``: fn(img_u8 [B,H,W,3], seg_u8
    [B,H,W,1], flow_f16 [B,H,W,2] or None) -> features [B, E], or (phase
    logits, anticipation) with ``features=False``. Extraction
    (``make_raw_feature_fn``) and the serving export
    (``serving/export.py``) both run it. With ``hold_kernel_weights`` the
    fused graph's kernel-layout weights (``mit_fused.kernel_weights``) are
    this module's buffers, laid out once, rather than read from the model's
    cache."""

    def __init__(self, model, use_fused: bool, *, features: bool = True,
                 out_dtype=torch.float16, hold_kernel_weights: bool = False):
        super().__init__()
        self.model, self.use_fused = model, use_fused
        self.features, self.out_dtype = features, out_dtype
        self.dequant = wire_dequant(next(model.parameters()).device)
        self._kw_spec = None
        if hold_kernel_weights and use_fused:
            leaves, self._kw_spec = tree_flatten(kernel_weights(model))
            for i, t in enumerate(leaves):
                self.register_buffer(f"kernel_weight{i}", t.clone())

    def forward(self, img_u8, seg_u8, flow_f16=None):
        img, seg = self.dequant(img_u8, seg_u8)
        flow = None if flow_f16 is None else flow_f16.to(torch.bfloat16)
        if self.use_fused:
            kw = None
            if self._kw_spec is not None:
                kw = tree_unflatten([getattr(self, f"kernel_weight{i}")
                                     for i in range(self._kw_spec.num_leaves)], self._kw_spec)
            out = fused_forward(self.model, img, seg, flow, return_features=self.features,
                                weights=kw)
        else:
            out = self.model.graph_forward(img, seg, flow, return_features=self.features,
                                           dtype=torch.bfloat16)
        if self.features:
            return out.to(self.out_dtype)
        return tuple(o.to(self.out_dtype) for o in out)


class ExtractGraph(FeatureGraph):
    """``FeatureGraph`` over extraction's batches, counted apart from the
    live session's frames (``counters()["extract_graph"]``)."""


class PinnedStage:
    """Pinned host copies of wire batches on their way to the card, in two
    sets used in turn: ``stage(batch)`` copies the host arrays into the next
    set (numpy arrays or CPU tensors; a batch with a tensor on the card
    passes as it is) and ``done()`` marks, on the current stream, the end of
    the work that reads that set. A set is written again only after its
    mark has passed. A batch of another layout allocates the sets anew.

    The copy is split by frames over ``COPIERS`` threads: on the H100 host
    one thread copies a 200-frame 224-px batch in ~15 ms, as long as the
    card's work on a b0 batch, and four make b0 extraction ~10% faster
    (``PERF.md``, section 6), though the copy is bound by the host's memory."""

    COPIERS = 4

    def __init__(self):
        self._layout, self._sets, self._marks = None, None, [None, None]
        self._next, self._current = 0, None
        self._pool = ThreadPoolExecutor(self.COPIERS, thread_name_prefix="pinned-stage")

    def stage(self, batch):
        batch = tuple(None if a is None else torch.as_tensor(a) for a in batch)
        self._current = None
        if any(a is not None and a.is_cuda for a in batch):
            return batch
        if layout(*batch) != self._layout:
            self._sets = [tuple(None if a is None else
                                torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                                for a in batch) for _ in range(2)]
            self._layout, self._marks, self._next = layout(*batch), [None, None], 0
        i = self._current = self._next
        self._next = 1 - i
        if self._marks[i] is not None:
            self._marks[i].synchronize()
        copies = []
        for buf, a in zip(self._sets[i], batch):
            if buf is not None:
                step = -(-a.shape[0] // self.COPIERS)
                copies += [self._pool.submit(buf[lo:lo + step].copy_, a[lo:lo + step])
                           for lo in range(0, a.shape[0], step)]
        for c in copies:
            c.result()
        return self._sets[i]

    def done(self):
        if self._current is not None:
            self._marks[self._current] = torch.cuda.Event()
            self._marks[self._current].record()


def make_raw_feature_fn(model, d2h_dtype=torch.float16, use_fused=None, weight_quant=None,
                        group=None):
    """Feature extractor over wire-format host batches (numpy or tensors):
    fn(img_u8, seg_u8, flow_f16 | None) -> [B, E] features in ``d2h_dtype``
    on the model's device. ``use_fused``: the fused serving graph (True) or
    the flax graph at bf16 (False); None takes ``use_fused_default``. The
    choice is ``fn.use_fused``.

    ``weight_quant="int8"`` holds the model's weights as int8 with fp32
    per-channel scales on its device (``serving/quant.py``, ``fn.held``) and
    dequantizes them to bf16 at every dispatch, feeding them to the same
    graph through ``torch.func.functional_call``, as the JAX package does
    (surgical_tpu/train/extract.py:122-134).

    ``group``: the process group that shares each batch
    (``torch.distributed.group.WORLD`` for the default group); None, the
    default, is this process alone, whatever group is initialised, so a
    caller whose ranks each extract their own frames is unaffected. Over a
    group of n ranks each
    call takes the padded global batch of B frames (B % n == 0, else it
    raises), runs this rank's B / n frames (``mesh.shard_batch``) and
    returns all B features, gathered in rank order. ``fn.rank`` is this
    rank within the group.

    On the card, in one process and without ``weight_quant``, a batch of
    host arrays goes through ``PinnedStage`` and the forward replays
    ``ExtractGraph`` (``fn.graph``; None elsewhere), whose first batch of a
    layout is eager and captures it; the features are a copy of the
    graphs' output buffer, which the next batch overwrites."""
    device = next(model.parameters()).device
    if use_fused is None:
        use_fused = use_fused_default(model.cfg, device)
    if weight_quant not in (None, "int8"):
        raise ValueError(f"unknown weight_quant {weight_quant!r} (int8|None)")
    serve = WireForward(model, use_fused, out_dtype=d2h_dtype)
    held = None
    if weight_quant == "int8":
        q_state, scales = quantize_state(model.state_dict())
        held = ({f"model.{k}": q_state[k] for k in scales},
                {f"model.{k}": s for k, s in scales.items()})

    rank, world = (0, 1) if group is None else mesh.rank_world(group)
    card = device.type == "cuda" and held is None and world == 1
    replay, pinned = (ExtractGraph(serve, model), PinnedStage()) if card else (None, None)

    def to_dev(a):
        return None if a is None else torch.as_tensor(a).to(device, non_blocking=True)

    @torch.no_grad()
    def feature_fn(img_u8, seg_u8, flow_f16):
        batch = (img_u8, seg_u8, flow_f16)
        if replay is not None:
            with span("extract.h2d"):
                staged = pinned.stage(batch)
            with span("extract.forward"):
                feats = replay(*staged).clone()  # a replay's output is the graphs' buffer
                pinned.done()
            return feats
        if world > 1:
            batch = mesh.shard_batch(batch, group)
        with span("extract.h2d"):
            args = tuple(map(to_dev, batch))
        with span("extract.forward"):
            if held is None:
                feats = serve(*args)
            else:
                feats = torch.func.functional_call(serve, dequantize_state(*held), args)
        return mesh.all_gather(feats, group) if world > 1 else feats

    feature_fn.use_fused = use_fused
    feature_fn.graph = replay
    feature_fn.held = held
    feature_fn.rank = rank
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
    ``batch_size`` frames, a shorter one padded to ``batch_size``; returns
    ([N, D] float32 features, timing stats)."""
    out = np.empty((total_frames, feature_dim), dtype=np.float32)
    stream = torch.cuda.Stream() if torch.cuda.is_available() else None
    pos = 0
    pending = None

    def drain(p):
        host, done, at, n = p
        with span("extract.drain"):
            if done is not None:
                done.synchronize()
            out[at:at + n] = host[:n].float().numpy()

    t0 = time.perf_counter()
    for batch in batches:
        n = batch[0].shape[0]
        if n > batch_size:
            raise ValueError(f"batch of {n} frames exceeds batch_size={batch_size}")
        feats = feature_fn(*mesh.pad_batch(tuple(batch), batch_size)[0])
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
    """Extract and publish the features as a FeatureStore. Over a process
    group (``feature_fn.rank``) rank 0 writes the store; the other ranks
    return (None, stats) after the last gather."""
    total = int(np.sum(lengths))
    feats, stats = extract_features(feature_fn, batches, total, feature_dim, batch_size)
    if getattr(feature_fn, "rank", 0) != 0:
        return None, stats
    store = FeatureStore.create(directory, feats, lengths, meta={**(meta or {}), **stats})
    return store, stats
