"""The streaming session's temporal leg as CUDA graphs with static state
buffers.

Per frame the temporal step (``OnlineMamba``, ``OnlineMSTCN`` or
``OnlineJamba``) and the
refiner's (``OnlineRefiner``) issue a few hundred small device operations at
fixed shapes and read nothing back, and the card waits on the host.
``TemporalGraph`` captures each step once per key (the feature's and the
state leaves' shapes and dtypes, ``state_key`` of both models, and the fp32
matmul precision, which picks the kernels a capture records) and replays it
(``serving/graphs.py``):

- the static buffers are the feature, every leaf of the temporal state (for
  Jamba its attention layers' K/V caches, which the step writes in place,
  and the stream's frame count) and the refiner's ring buffer;
- each graph runs its step on them (the refiner's on the temporal graph's
  final stage and the feature), then copies the new state into the static
  one: no read of the old state follows a write;
- a replay copies the feature in (and a state that is not the static
  buffers, such as a ``reset``'s), replays each graph inside its span
  (``session.temporal``, ``session.refiner``) and returns the static states,
  which the next replay updates in place, and a clone of the output.

The graphs record exactly the operations the eager steps issue, in their
order and dtypes: the same numbers, bit for bit.
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch.utils import _pytree as pytree

from surgical_tpu_torch.core.state import state_key
from surgical_tpu_torch.serving.graphs import GraphedLeg, layout
from surgical_tpu_torch.utils.trace import span


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
    into graphs of the memory pool ``pool`` on the static ``feat``, ``state``
    and ``refiner_state``, each ending in the copy of its step's new state
    into the static one: (the graphs in replay order, the leg's output)."""
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


_Captured = namedtuple("_Captured", "graphs output feat state leaves refiner_state")


class TemporalGraph(GraphedLeg):
    """The leg of ``temporal`` (an ``OnlineMSTCN``, ``OnlineMamba`` or
    ``OnlineJamba``) and
    ``refiner`` (an ``OnlineRefiner`` or None): (state, refiner state,
    feature [E]) -> (state', refiner state', logits)."""

    def __init__(self, temporal, refiner=None):
        super().__init__(next(temporal.model.parameters()).device)
        self.temporal, self.refiner = temporal, refiner

    def key(self, state, refiner_state, feat) -> tuple:
        c = self.captured
        leaves = c.leaves if c is not None and state is c.state else pytree.tree_leaves(state)
        models = (self.temporal.model, None if self.refiner is None else self.refiner.model)
        return (layout(feat, *leaves, refiner_state), state_key(*models),
                torch.get_float32_matmul_precision())

    def eager(self, state, refiner_state, feat):
        return eager_leg(self.temporal, self.refiner, state, refiner_state, feat)

    def buffers(self, state, refiner_state, feat):
        # zeros, not garbage: a step may index with its state (Jamba's K/V
        # write at the frame count), and a capture that runs its operations
        # (the CPU tests' stand-in) must stay in range
        zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        return pytree.tree_map_only(torch.Tensor, zeros, (state, refiner_state, feat))

    def capture(self, pool, buffers, state, refiner_state, feat):
        static, static_refiner, static_feat = buffers
        new, new_refiner, out = self.eager(state, refiner_state, feat)
        graphs, output = record(self.temporal, self.refiner, static_feat, static,
                                static_refiner, pool)
        leaves = pytree.tree_leaves(static)
        _write(leaves, pytree.tree_leaves(new))
        if new_refiner is not None:
            static_refiner.copy_(new_refiner)
        return ((static, static_refiner, out),
                _Captured(graphs, output, static_feat, static, leaves, static_refiner))

    def replay(self, state, refiner_state, feat):
        c = self.captured
        if state is not c.state:
            _write(c.leaves, pytree.tree_leaves(state))
        if refiner_state is not c.refiner_state:
            c.refiner_state.copy_(refiner_state)
        c.feat.copy_(feat)
        with span("session.temporal"):
            c.graphs[0].replay()
        if self.refiner is not None:
            with span("session.refiner"):
                c.graphs[1].replay()
        return c.state, c.refiner_state, c.output.clone()


COUNTS = TemporalGraph.COUNTS
