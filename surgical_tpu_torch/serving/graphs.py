"""A leg of work captured once as CUDA graphs and replayed: the live
session's two legs (``serving/feature_graph.py``,
``serving/temporal_graph.py``) and the backbone trainer's step
(``train/train_graph.py``).

A frame of a new key releases the old graphs and their pool, runs eagerly
on a side stream that starts after the device's work so far (which loads
the kernels, cuDNN plans and cuBLAS workspace of that stream) and is
captured there into one new pool; the replays' stream waits for the side
stream, and the eager output is marked as used on it. The key is taken
again after the capture, since the eager frame may make state that the
graphs hold (an optimizer's momentum buffers). A frame of the same key is
replayed. On the CPU, or where the leg does not engage, the frame runs
eagerly. The caching allocator ties a block to the stream that allocated
it, so a leg's static buffers come from the replays' stream (``buffers``)
or from the side one (``capture``), as the leg chooses.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def layout(*tensors) -> tuple:
    """The shapes and dtypes of ``tensors`` (None stays None)."""
    return tuple(None if a is None else (tuple(a.shape), a.dtype) for a in tensors)


class GraphedLeg:
    """A leg on ``device``. A subclass gives, on a frame's arguments: ``key``,
    ``eager`` (the CPU's path), ``buffers`` (static buffers from the replays'
    stream, or None), ``capture(pool, buffers, *args)`` (the eager frame and
    its capture into graphs of ``pool`` on the side stream: (the eager
    output, what the replays need, kept as ``captured``)), ``replay`` and
    optionally ``engages`` (False: this frame runs eagerly on the card too).
    ``GRAD``: the grad mode its frames run in. ``COUNTS``
    (``utils/trace.py::counters()``): each leg's captures, replayed frames
    and eager frames (on the CPU, where it does not engage, or a
    capture's)."""

    GRAD = False

    def __init_subclass__(cls):
        cls.COUNTS = {"captures": 0, "replays": 0, "eager": 0}

    def __init__(self, device: torch.device):
        self.device = device
        self._key = self.captured = None

    def buffers(self, *args):
        return None

    def engages(self, *args) -> bool:
        return True

    def __call__(self, *args):
        with torch.set_grad_enabled(self.GRAD):
            if self.device.type != "cuda" or not self.engages(*args):
                self.COUNTS["eager"] += 1
                return self.eager(*args)
            key = self.key(*args)
            if key == self._key:
                out = self.replay(*args)
                self.COUNTS["replays"] += 1
                return out
            self._key = self.captured = None  # the old graphs and their pool go first
            torch.cuda.synchronize(self.device)
            buffers = self.buffers(*args)
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out, self.captured = self.capture(torch.cuda.graph_pool_handle(), buffers, *args)
            current.wait_stream(side)
            pytree.tree_map_only(torch.Tensor, lambda t: t.record_stream(current), out)
            self._key = self.key(*args)
            self.COUNTS["captures"] += 1
            self.COUNTS["eager"] += 1
            return out
