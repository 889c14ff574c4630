"""The streaming session's feature leg as CUDA graphs of the glue between
the MiT kernel calls.

At B = 1 the serving graph (``train/extract.py::WireForward``) issues about
900 small device operations per b0 frame, nearly all of them the plain
PyTorch glue of ``models/mit_fused.py::fused_forward``; the card then
waits on the host. Every frame has the same shapes, so ``FeatureGraph``
captures the glue once and replays it:

- the leg is cut into segments at every call of a MiT kernel entry
  (``fused_mit_block``, ``fused_mit_block_packed2``, ``fused_mit_stage``)
  and at every boundary of the program's spans (``mit.prompts``,
  ``mit.stage1`` .. ``mit.stage4``) where operations were issued since the
  last cut. Each segment is one ``torch.cuda.CUDAGraph``; all share one
  memory pool. b0 at B = 1 gives 15 segments around 8 kernel calls, b3
  35 around 28, with flow or without; the flax graph (``use_fused=False``)
  has no kernel call and no span, so it is one segment;
- a replay copies the frame into the static input buffers, then walks the
  segments in order: each graph is replayed, each kernel is called eagerly
  through the entry that ``mit_fused`` holds at that moment, on the tensors
  that the graphs wrote, and its output is copied into the buffer the next
  segment reads; each span is entered and left where the eager leg enters
  and leaves it.

The kernels stay outside the graphs so that whatever wraps their entries
sees every call: the launch counters (``.launches``), the launch's error
check, and a benchmark's tracer that patches the entries. Every segment
issues the operations ``fused_forward`` issues eagerly, in its order and
dtypes: the same numbers, bit for bit.

A capture depends on ``graph_key``: the frame's shapes and dtypes, whether
flow is present, and the address and in-place version of every backbone
parameter and buffer. A frame of another key is run eagerly (which loads
the kernels, the cuDNN plans and the cuBLAS workspace of the capture's side
stream) and then captured; the old graphs and their pool are released
first. Capturing rebinds ``mit_fused``'s kernel entries and ``span`` for
the capture's duration (calls from other threads pass straight through).

Only CUDA tensors are captured; on the CPU the leg runs eagerly.
``COUNTS`` (``utils/trace.py::counters()["feature_graph"]``) counts the
captures made, the frames replayed and the frames run eagerly (on the CPU,
or the frame of a capture).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from surgical_tpu_torch.models import mit_fused
from surgical_tpu_torch.utils.trace import span

ENTRIES = ("fused_mit_block", "fused_mit_block_packed2", "fused_mit_stage")
COUNTS = {"captures": 0, "replays": 0, "eager": 0}

_GRAPH, _KERNEL, _ENTER, _EXIT = range(4)


def graph_key(model, frame) -> tuple:
    """What a capture of ``model``'s leg on ``frame`` (tensors, flow None or
    not) depends on: the frame's shapes and dtypes, and every parameter's
    and buffer's address and in-place version (``load_state_dict`` writes in
    place; the flow encoder's BatchNorm statistics are buffers). One walk of
    the module tree's dicts, which is ~6x faster than ``parameters()`` and
    ``buffers()``: the key is taken every frame."""
    shapes = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in frame)
    tensors, modules = [], [model]
    while modules:
        m = modules.pop()
        if m is not None:
            tensors += m._parameters.values()
            tensors += m._buffers.values()
            modules += m._modules.values()
    return shapes, tuple((t.data_ptr(), t._version) for t in tensors if t is not None)


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
    pool ``pool``, cut at the kernel entries and spans: (the steps, in
    order, and the pass's output, a tensor of the pool). A step is
    ``(_GRAPH, graph)``, ``(_KERNEL, entry name, args, kwargs, output)``,
    ``(_ENTER, span name)`` or ``(_EXIT,)``. The kernels run eagerly on the
    tensors of the capture, whose graphs have not run yet."""
    recorder = _Recorder(pool)
    with _rebound(recorder), recorder:
        recorder.begin()
        try:
            output = forward(*inputs)
        finally:
            if recorder.graph is not None:  # also a capture that an error left open
                recorder.end()
    return recorder.steps, output


class FeatureGraph:
    """The feature leg ``forward`` (fn(img_u8, seg_u8, flow_f16 or None) ->
    [B, E], a ``WireForward``) over ``model``'s weights, graphed when they
    are on the card, as the module docstring says.

    Calling it with one frame's wire tensors or arrays ([1, H, W, 3] u8,
    [1, H, W, 1] u8, [1, H, W, 2] f16 or None) gives the features. A
    replayed frame's are the graphs' static output, which the next call
    overwrites. The memory holds one graph pool: the glue's activations of
    one frame, plus the kernels' outputs between segments and the static
    inputs."""

    def __init__(self, forward, model):
        self.forward, self.model = forward, model
        self.device = next(model.parameters()).device
        self._release()

    def _release(self) -> None:
        self._key = self._steps = self._inputs = self._output = None

    @property
    def segments(self) -> int:
        """The graphs of the current capture (0 before the first)."""
        return sum(1 for s in self._steps or () if s[0] == _GRAPH)

    @torch.no_grad()
    def __call__(self, img_u8, seg_u8, flow_f16):
        frame = tuple(None if a is None else torch.as_tensor(a)
                      for a in (img_u8, seg_u8, flow_f16))
        if self.device.type != "cuda":
            COUNTS["eager"] += 1
            return self.forward(*(None if a is None else a.to(self.device) for a in frame))
        key = graph_key(self.model, frame)
        if key != self._key:
            out = self._capture(frame)
            self._key = key
            return out
        for buf, a in zip(self._inputs, frame):
            if buf is not None:
                buf.copy_(a, non_blocking=True)
        self._replay()
        COUNTS["replays"] += 1
        return self._output

    def _replay(self) -> None:
        spans = []
        for step in self._steps:
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

    def _capture(self, frame):
        """Runs ``frame`` eagerly on a side stream, captures the leg there,
        and returns the eager features."""
        self._release()
        torch.cuda.synchronize(self.device)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            inputs = tuple(None if a is None else
                           torch.empty(a.shape, dtype=a.dtype, device=self.device).copy_(a)
                           for a in frame)
            out = self.forward(*inputs)
            steps, output = record(self.forward, inputs, torch.cuda.graph_pool_handle())
        current.wait_stream(side)
        out.record_stream(current)
        self._steps, self._inputs, self._output = steps, inputs, output
        COUNTS["captures"] += 1
        COUNTS["eager"] += 1
        return out
