"""The streaming session's feature leg as CUDA graphs of the glue between
the MiT kernel calls.

At B = 1 the serving graph (``train/extract.py::WireForward``) issues about
900 small device operations per b0 frame, nearly all of them the plain
PyTorch glue of ``models/mit_fused.py::fused_forward``, and the card waits
on the host. ``FeatureGraph`` captures the glue once per key (the frame's
shapes and dtypes, flow or not, ``state_key`` of the backbone, whose flow
encoder's BatchNorm statistics are buffers, and ``mit_fused.routes()``) and replays it
(``serving/graphs.py``):

- the leg is cut into segments at every call of a MiT kernel entry
  (``ENTRIES``) and at every boundary of the program's spans
  (``mit.prompts``, ``mit.stage1`` .. ``mit.stage4``) where operations were
  issued since the last cut. Each segment is one ``torch.cuda.CUDAGraph``
  of the capture's pool: b0 at B = 1 gives 15 around 8 kernel calls, b3 35
  around 28, with flow or without; the flax graph (``use_fused=False``) is
  one segment. A capture rebinds ``mit_fused``'s kernel entries and
  ``span`` for its thread;
- a replay copies the frame into the static inputs and walks the segments:
  each graph is replayed, each kernel is called eagerly through the entry
  that ``mit_fused`` holds then, on the tensors the graphs wrote, and its
  output copied into the buffer the next segment reads; each span is
  entered and left where the eager leg enters and leaves it.

The kernels stay outside the graphs so that whatever wraps their entries
(``.launches``, the launch's error check, a benchmark's tracer) sees every
call. Every segment issues the operations ``fused_forward`` issues eagerly,
in its order and dtypes: the same numbers, bit for bit.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from surgical_tpu_torch.core.state import state_key
from surgical_tpu_torch.models import mit_fused
from surgical_tpu_torch.serving.graphs import GraphedLeg, layout
from surgical_tpu_torch.utils.trace import span

ENTRIES = ("fused_mit_block", "fused_mit_block_packed2", "fused_mit_stage")

_GRAPH, _KERNEL, _ENTER, _EXIT = range(4)


class _Recorder(TorchDispatchMode):
    """Captures one pass of the leg as segments. As a dispatch mode it sees
    every operation, so a span boundary cuts only a segment that issued
    one."""

    def __init__(self, pool):
        super().__init__()
        self.pool, self.steps = pool, []
        self.graph, self.issued = None, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.issued = True
        return func(*args, **(kwargs or {}))

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.issued = False  # capture_begin's own fills of the RNG state are not the leg's

    def end(self):
        self.graph.capture_end()
        if self.issued:
            self.steps.append((_GRAPH, self.graph))
        self.graph = None

    def cut(self):
        if self.issued:
            self.end()
            self.begin()

    @contextlib.contextmanager
    def span(self, name: str):
        self.cut()
        self.steps.append((_ENTER, name))
        yield
        self.cut()
        self.steps.append((_EXIT,))

    def kernel(self, name: str, entry):
        def call(*args, **kwargs):
            self.end()
            out = entry(*args, **kwargs)  # on the tensors of a capture: the numbers are unused
            self.steps.append((_KERNEL, name, args, kwargs, out))
            self.begin()
            return out
        return call


@contextlib.contextmanager
def _rebound(recorder):
    """``mit_fused``'s kernel entries and ``span`` bound to ``recorder`` for
    this thread; other threads reach the bindings of before."""
    owner = threading.get_ident()
    saved = {n: getattr(mit_fused, n) for n in (*ENTRIES, "span")}

    def mine(ours, theirs):
        return lambda *a, **k: (ours if threading.get_ident() == owner else theirs)(*a, **k)

    for n in ENTRIES:
        setattr(mit_fused, n, mine(recorder.kernel(n, saved[n]), saved[n]))
    mit_fused.span = mine(recorder.span, saved["span"])
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(mit_fused, n, f)


def record(forward, inputs, pool):
    """One pass of ``forward(*inputs)`` captured into graphs of the memory
    pool ``pool``, cut at the kernel entries and spans: (the steps in order,
    the pass's output). A step is ``(_GRAPH, graph)``, ``(_KERNEL, entry
    name, args, kwargs, output)``, ``(_ENTER, span name)`` or ``(_EXIT,)``.
    The kernels run eagerly on the capture's tensors (the numbers unused)."""
    recorder = _Recorder(pool)
    with _rebound(recorder), recorder:
        recorder.begin()
        try:
            output = forward(*inputs)
        finally:
            if recorder.graph is not None:  # also a capture that an error left open
                recorder.end()
    return recorder.steps, output


class FeatureGraph(GraphedLeg):
    """The feature leg ``forward`` (a ``WireForward``: img_u8, seg_u8,
    flow_f16 or None -> [B, E]) over ``model``'s weights. Called with one
    frame's wire tensors or arrays ([1, H, W, 3] u8, [1, H, W, 1] u8,
    [1, H, W, 2] f16 or None) it gives the features; a replayed frame's are
    the static output, which the next call overwrites."""

    def __init__(self, forward, model):
        super().__init__(next(model.parameters()).device)
        self.forward, self.model = forward, model

    @property
    def segments(self) -> int:
        """The graphs of the current capture (0 before the first)."""
        steps = self.captured[0] if self.captured else ()
        return sum(1 for s in steps if s[0] == _GRAPH)

    def __call__(self, img_u8, seg_u8, flow_f16):
        return super().__call__(tuple(None if a is None else torch.as_tensor(a)
                                      for a in (img_u8, seg_u8, flow_f16)))

    def key(self, frame) -> tuple:
        return layout(*frame), state_key(self.model), mit_fused.routes()

    def eager(self, frame):
        return self.forward(*(None if a is None else a.to(self.device) for a in frame))

    def capture(self, pool, buffers, frame):
        inputs = tuple(None if a is None else
                       torch.empty(a.shape, dtype=a.dtype, device=self.device).copy_(a)
                       for a in frame)
        out = self.forward(*inputs)
        steps, output = record(self.forward, inputs, pool)
        return out, (steps, inputs, output)

    def replay(self, frame):
        steps, inputs, output = self.captured
        for buf, a in zip(inputs, frame):
            if buf is not None:
                buf.copy_(a, non_blocking=True)
        spans = []
        for step in steps:
            kind = step[0]
            if kind == _GRAPH:
                step[1].replay()
            elif kind == _KERNEL:
                _, name, args, kwargs, out = step
                out.copy_(getattr(mit_fused, name)(*args, **kwargs))
            elif kind == _ENTER:
                spans.append(span(step[1]))
                spans[-1].__enter__()
            else:
                spans.pop().__exit__(None, None, None)
        return output


COUNTS = FeatureGraph.COUNTS
