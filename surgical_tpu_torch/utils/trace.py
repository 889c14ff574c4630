"""The program's own spans and counters.

``span(name)`` marks one layer boundary of a hot path as the host event
``stt:<name>`` on ``torch.profiler``'s clock, the clock of the device
activity it traces. With no profiler active it returns one shared null
context and makes no dispatcher call (a ``record_function`` costs ~10 us
even then), so the spans stay in the code that users run. Run any call
under ``torch.profiler.profile`` to see them:

- ``extract.h2d``, ``extract.forward``, ``extract.drain``
  (``train/extract.py``): the wire batch's copies to the device; the
  dequantization and the serving graph's issue; the wait for the last
  batch's features and their write into the output;
- ``mit.prompts``, ``mit.stage1`` .. ``mit.stage4``
  (``models/mit_fused.py::fused_forward``): the prompt cascade; each stage
  from its patch embed to its norm;
- ``train.input``, ``train.forward``, ``train.backward``, ``train.update``
  (``train/backbone.py``): copies, dequantization and augmentation; the
  graph's forward and the loss; ``zero_grad`` and ``backward``; the
  optimizer step and the BatchNorm statistics;
- ``session.features``, ``session.temporal``, ``session.refiner``
  (``serving/online.py::OnlineSession``): the feature leg's issue, the
  temporal step, the refiner step;
- ``predict.temporal``, ``predict.refiner`` (``train/refiner.py``): the two
  models of ``predict_video``;
- ``jamba.mamba``, ``jamba.attention``, ``jamba.mlp`` (``models/jamba.py``,
  ``serving/online.py::OnlineJamba``): each Jamba layer's norm, mixer and
  residual add, and its MLP half, inside ``predict.temporal`` offline and
  inside ``session.temporal`` in an eager or captured step (a replayed
  step fires only ``session.temporal``);
- ``flow.h2d``, ``flow.forward``, ``flow.drain``
  (``models/raft.py::make_flow_fn``): the frames' copy to the device; the
  mapping, padding and RAFT's issue; the wait for the flows and their copy
  to the host; inside ``flow.forward``, ``flow.encode`` (both encoders, the
  correlation volume and its pyramid), per iteration ``flow.lookup`` and
  ``flow.update``, and ``flow.upsample`` (``RAFT.forward``);
  ``flow.load``, ``flow.save`` (``flow/precompute.py``): a pair's decode and
  its file's atomic write;
- ``gc.gen0`` .. ``gc.gen2``: a pause of Python's garbage collector.

``counters()`` is a snapshot for an operator: the collector's collections
and pauses per generation (counted whether or not a profiler runs), the
kernels' launch counts and the glue LayerNorm's calls by route, the
streaming session's feature-leg graphs (``serving/feature_graph.py``:
captures made, frames replayed, frames run eagerly) and temporal-leg graphs
(``serving/temporal_graph.py``: the same three), the backbone trainer's step
graphs (``train/train_graph.py``: captures, replayed steps, eager steps),
RAFT's batches, pairs, iterations and largest batch (``models/raft.py``),
Jamba's forward calls and frames, its streaming steps, its K/V cache's
capacity and the longest stream it held (``models/jamba.py``), and the CUDA
caching allocator's retries, device allocations and frees.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "stt:"
_NULL = contextlib.nullcontext()


def span(name: str):
    """``record_function("stt:" + name)`` while a profiler runs, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


class GcPauses:
    """A ``gc.callbacks`` hook: per generation the collections, their summed
    pause and the longest, in ms; under a profiler each pause is also the
    span ``gc.gen<g>``."""

    def __init__(self):
        self.collections = [0, 0, 0]
        self.pause_ms = [0.0, 0.0, 0.0]
        self.max_pause_ms = [0.0, 0.0, 0.0]
        self._t0 = None
        self._span = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _profiler._is_profiler_enabled:
                self._span = torch.profiler.record_function(f"{PREFIX}gc.gen{info['generation']}")
                self._span.__enter__()
            self._t0 = time.perf_counter_ns()
            return
        if self._t0 is None:  # appended to gc.callbacks during a collection
            return
        ms = (time.perf_counter_ns() - self._t0) / 1e6
        self._t0 = None
        g = info["generation"]
        self.collections[g] += 1
        self.pause_ms[g] += ms
        self.max_pause_ms[g] = max(self.max_pause_ms[g], ms)
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def snapshot(self) -> dict:
        return {f"gen{g}": {"collections": self.collections[g], "pause_ms": self.pause_ms[g],
                            "max_pause_ms": self.max_pause_ms[g]} for g in range(3)}


GC = GcPauses()
gc.callbacks.append(GC)


def counters() -> dict:
    """{"gc": per generation {collections, pause_ms, max_pause_ms},
    "launches": each kernel wrapper's launch count and the graph glue's
    LayerNorm calls by route (``layernorm_route_kernel``,
    ``layernorm_route_plain``: ``models/_ops.py::layernorm``), "feature_graph":
    {captures, replays, eager} of the session's feature leg,
    "temporal_graph": the same of its temporal leg, "train_graph": the same
    of the backbone trainer's step, "extract_graph": the same of
    extraction's batches, "raft":
    {batches, pairs, iterations, largest_batch} of RAFT's forward, "jamba":
    {forwards, frames, steps, kv_capacity, kv_high_water}, and with
    a card "cuda_alloc": {num_alloc_retries, num_device_alloc,
    num_device_free}}."""
    from surgical_tpu_torch.kernels import mit_block, selective_scan
    from surgical_tpu_torch.models import _ops, jamba, raft
    from surgical_tpu_torch.serving import feature_graph, temporal_graph
    from surgical_tpu_torch.train import extract, train_graph

    out = {"gc": GC.snapshot(),
           "launches": {**mit_block.launch_counts(),
                        "selective_scan": selective_scan.selective_scan.launches,
                        "selective_scan_backward":
                            selective_scan.selective_scan_backward.launches,
                        "layernorm_route_kernel": _ops.LAYERNORM_ROUTES["kernel"],
                        "layernorm_route_plain": _ops.LAYERNORM_ROUTES["plain"]},
           "feature_graph": dict(feature_graph.COUNTS),
           "temporal_graph": dict(temporal_graph.COUNTS),
           "train_graph": dict(train_graph.COUNTS),
           "extract_graph": dict(extract.ExtractGraph.COUNTS), "raft": dict(raft.COUNTS),
           "jamba": dict(jamba.COUNTS)}
    if torch.cuda.is_available():
        stats = torch.cuda.memory_stats_as_nested_dict()  # memory_stats() also flattens and sorts
        out["cuda_alloc"] = {k: stats.get(k, 0) for k in
                             ("num_alloc_retries", "num_device_alloc", "num_device_free")}
    return out
