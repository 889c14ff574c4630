"""The streaming session's temporal leg as CUDA graphs with static state
buffers.

Per frame the session's temporal leg (``OnlineMamba.step`` or
``OnlineMSTCN.step``, then with a refiner ``OnlineRefiner.step``) issues
a few hundred small device operations at fixed shapes and reads nothing
back to the host; the card then waits on the host. ``TemporalGraph``
captures each step once and replays it:

- the static buffers are the frame's feature, every leaf of the temporal
  state (``torch.utils._pytree.tree_leaves``) and the refiner's ring
  buffer;
- the temporal graph runs the temporal step on them and then copies the new
  state leaves into the static state; the refiner graph runs the refiner
  step on the temporal graph's final stage and the same feature and then
  copies the new ring buffer into the static one. The steps' own operations
  come first, so no read of the old state follows a write;
- a replay copies the feature into its static buffer, replays the temporal
  graph inside the span ``session.temporal`` and the refiner graph inside
  ``session.refiner``, and returns a clone of the static output, which the
  caller owns. The state it returns is the static buffers, which the next
  replay updates in place. A state that is not the static buffers (a new
  session state, or one a ``reset`` made) is copied in first.

The graphs record exactly the operations the eager steps issue, in their
order and dtypes: the same numbers, bit for bit.

A capture depends on the key: the feature's and the state leaves' shapes
and dtypes, the address and in-place version of every parameter and
buffer of the temporal and refiner models (``feature_graph.graph_key``'s
walk; ``load_state_dict`` writes in place), and the fp32 matmul precision
(TF32 or not), which picks the kernels a capture records. A frame of
another key is run eagerly on a side stream (which loads the cuBLAS
workspace of the capture's stream) and then captured; the old graphs and
their pool are released first.

Only a model on the card is captured; on the CPU the leg runs eagerly.
``COUNTS`` (``utils/trace.py::counters()["temporal_graph"]``) counts the
captures made, the frames replayed and the frames run eagerly (on the CPU,
or the frame of a capture).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from surgical_tpu_torch.serving.feature_graph import graph_key
from surgical_tpu_torch.utils.trace import span

COUNTS = {"captures": 0, "replays": 0, "eager": 0}


def _final(logits: torch.Tensor) -> torch.Tensor:
    """The temporal step's final stage: MS-TCN's logits are [stages, out]."""
    return logits[-1] if logits.dim() == 2 else logits


def eager_leg(temporal, refiner, state, refiner_state, feat):
    """One frame's feature [E] through the temporal step and, with a
    refiner, the refiner step on the final stage and the same feature:
    (state', refiner_state', logits)."""
    with span("session.temporal"):
        state, logits = temporal.step(state, feat)
    g = _final(logits)
    if refiner is None:
        return state, refiner_state, g
    with span("session.refiner"):
        refiner_state, refined = refiner.step(refiner_state, g, feat)
    return state, refiner_state, refined


def _write(dst_leaves, src_leaves) -> None:
    for dst, src in zip(dst_leaves, src_leaves, strict=True):
        dst.copy_(src)


def record(temporal, refiner, feat, state, refiner_state, pool):
    """One step each of ``temporal`` and, when given, ``refiner`` captured
    into graphs of the memory pool ``pool``, on the static ``feat``,
    ``state`` and ``refiner_state``, each graph ending in the copy of its
    step's new state into the static one: (the graphs in replay order, the
    leg's output, a tensor of the pool)."""
    graphs = []

    def capture(step):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            return step()
        finally:
            graph.capture_end()
            graphs.append(graph)

    def temporal_step():
        new, logits = temporal.step(state, feat)
        _write(pytree.tree_leaves(state), pytree.tree_leaves(new))
        return _final(logits)

    def refiner_step():
        new, refined = refiner.step(refiner_state, g, feat)
        refiner_state.copy_(new)
        return refined

    g = capture(temporal_step)
    return graphs, (g if refiner is None else capture(refiner_step))


def _empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


class TemporalGraph:
    """The temporal leg of ``temporal`` (an ``OnlineMSTCN`` or
    ``OnlineMamba``) and ``refiner`` (an ``OnlineRefiner`` or None), graphed
    when their models are on the card, as the module docstring says.

    Calling it with (state, refiner state, feature [E]) gives (state',
    refiner state', logits). On the card the states it gives are its static
    buffers, updated in place by the next call; the logits are a fresh
    tensor. The memory holds one graph pool (one frame's activations of both
    steps) and the static buffers."""

    def __init__(self, temporal, refiner=None):
        self.temporal, self.refiner = temporal, refiner
        self.device = next(temporal.model.parameters()).device
        self._release()

    def _release(self) -> None:
        self._key = self._graphs = self._output = None
        self._feat = self._state = self._leaves = self._refiner_state = None

    def _graph_key(self, feat, leaves, refiner_state) -> tuple:
        return (graph_key(self.temporal.model, (feat, *leaves, refiner_state)),
                None if self.refiner is None else graph_key(self.refiner.model, ()),
                torch.get_float32_matmul_precision())

    @torch.no_grad()
    def __call__(self, state, refiner_state, feat):
        if self.device.type != "cuda":
            COUNTS["eager"] += 1
            return eager_leg(self.temporal, self.refiner, state, refiner_state, feat)
        leaves = self._leaves if state is self._state else pytree.tree_leaves(state)
        key = self._graph_key(feat, leaves, refiner_state)
        if key != self._key:
            out = self._capture(state, refiner_state, feat)
            self._key = key
            return out
        if state is not self._state:
            _write(self._leaves, leaves)
        if refiner_state is not self._refiner_state:
            self._refiner_state.copy_(refiner_state)
        self._feat.copy_(feat)
        with span("session.temporal"):
            self._graphs[0].replay()
        if self.refiner is not None:
            with span("session.refiner"):
                self._graphs[1].replay()
        COUNTS["replays"] += 1
        return self._state, self._refiner_state, self._output.clone()

    def _capture(self, state, refiner_state, feat):
        """Runs the frame eagerly on a side stream, captures both steps
        there on new static buffers, writes the eager frame's new state into
        them and returns (the static states, the eager logits)."""
        self._release()
        torch.cuda.synchronize(self.device)
        # the static buffers come from the replays' stream
        static = pytree.tree_map(_empty, state)
        static_refiner = None if refiner_state is None else _empty(refiner_state)
        static_feat = _empty(feat)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            new, new_refiner, out = eager_leg(self.temporal, self.refiner, state,
                                              refiner_state, feat)
            graphs, output = record(self.temporal, self.refiner, static_feat, static,
                                    static_refiner, torch.cuda.graph_pool_handle())
            _write(pytree.tree_leaves(static), pytree.tree_leaves(new))
            if new_refiner is not None:
                static_refiner.copy_(new_refiner)
        current.wait_stream(side)
        out.record_stream(current)
        self._graphs, self._output, self._feat = graphs, output, static_feat
        self._state, self._leaves = static, pytree.tree_leaves(static)
        self._refiner_state = static_refiner
        COUNTS["captures"] += 1
        COUNTS["eager"] += 1
        return static, static_refiner, out
