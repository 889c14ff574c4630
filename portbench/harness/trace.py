"""The traced run: the benchmark's spans and the device's timeline.

``Tracer`` holds ``torch.profiler`` over a stretch of the window and, for
that stretch, wraps the program's kernel entry points in spans of the
benchmark's own (``KERNEL_ENTRIES``), each call adding its least time at
the card's peaks (``reference/work.py``) to its span's sum. ``Timeline``
is what the per-layer readers see: every device operation with its
duration and the innermost benchmark span its launch fell in, the spans'
host intervals, and the union of the device's busy intervals.

A device operation is tied to the host call that launched it by the
profiler's correlation id (the CUDA runtime call and the operation share
it); the launch's host time lies inside the span. Copies (``Memcpy``) and
memsets are device operations like kernels.

``_busy_us``' union of intervals is a copy of
``surgical_tpu_torch/profile_extract.py``'s.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from collections import defaultdict

import torch

from reference import work

SPAN = "portbench:"


def _block_bound(x, k, v, weights, **kw):
    B, N, C = x.shape
    return work.bound_s(*_bf16(work.block_work(B, N, C, k.shape[1], weights["w1"].shape[-1])))


def _packed2_bound(x, k, v, packed, **kw):
    B, N, C = x.shape
    return work.bound_s(*_bf16(work.block_work(B, N, C, k.shape[1], packed["w1"].shape[-1] // 2)))


def _stage_bound(x, base, sw, **kw):
    B, N, C = x.shape
    depth, hidden = sw["wq"].shape[0], sw["w1"].shape[-1]
    Cb = base.shape[-1] if base is not None else 0
    C4 = sw["lww"].shape[-1] if "lww" in sw else 0
    return work.bound_s(*_bf16(work.stage_work(B, N, C, hidden, depth, Cb, C4)))


def _scan_bound(x, dt, A, B, C, D, *a, **kw):
    Bt, T, Dd = x.shape
    return work.bound_s(*work.scan_work(Bt, T, Dd, A.shape[-1]))


def _bf16(bytes_flops):
    nbytes, flops = bytes_flops
    return nbytes, flops / work.BF16_FLOPS


# (module, attribute, span, least time of one call from its arguments)
KERNEL_ENTRIES = (
    ("surgical_tpu_torch.models.mit_fused", "fused_mit_block", "mit_block", _block_bound),
    ("surgical_tpu_torch.models.mit_fused", "fused_mit_block_packed2", "mit_packed2",
     _packed2_bound),
    ("surgical_tpu_torch.models.mit_fused", "fused_mit_stage", "mit_stage", _stage_bound),
    ("surgical_tpu_torch.kernels.selective_scan", "selective_scan", "scan", _scan_bound),
)


def span(name: str):
    """A benchmark span around a call into the program."""
    return torch.profiler.record_function(SPAN + name)


class Tracer:
    """Profiles the device and the benchmark's spans while active."""

    def __init__(self, device=torch.device("cuda")):
        self.device = device
        self.bounds = defaultdict(float)
        self._patched = []
        self._prof = None
        self.window_s = 0.0

    def _wrap(self, fn, name, bound):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.bounds[name] += bound(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapper  # carries fn's attributes (the wrappers' launch counters)

    def __enter__(self):
        for mod_name, attr, name, bound in KERNEL_ENTRIES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._patched.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name, bound))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        for mod, attr, fn in self._patched:
            fn.__dict__.update(getattr(mod, attr).__dict__)  # counts made meanwhile
            setattr(mod, attr, fn)
        self._patched = []
        return False

    def timeline(self) -> "Timeline":
        return Timeline(self._prof.profiler.kineto_results.events(), self.window_s)


def _interval_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000


def _is_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


class Timeline:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        device, launches, spans, host = [], {}, defaultdict(list), []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if _is_annotation(e) or name.startswith(SPAN):
                    continue
                device.append((name, *_interval_ns(e), e.correlation_id()))
            elif name.startswith(SPAN):
                spans[name[len(SPAN):]].append(_interval_ns(e))
            elif name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = _interval_ns(e)[0]
            else:
                host.append((*_interval_ns(e), name))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.spans.items()}
        # (name, start ns, end ns, launch host ns or None)
        self.ops = [(n, s, t, launches.get(c)) for n, s, t, c in sorted(device, key=lambda d: d[1])]
        self.linked = sum(1 for o in self.ops if o[3] is not None)
        self.host = host

    def in_span(self, name: str, t) -> bool:
        if t is None or name not in self.spans:
            return False
        i = bisect.bisect_right(self._starts[name], t) - 1
        return i >= 0 and self.spans[name][i][1] >= t

    def ops_under(self, names) -> list:
        return [o for o in self.ops if any(self.in_span(n, o[3]) for n in names)]

    def device_s(self, ops=None) -> float:
        """Summed durations of ``ops`` (all by default), seconds."""
        return sum(t - s for _, s, t, _ in (self.ops if ops is None else ops)) / 1e9

    def busy_s(self) -> float:
        return _busy_us([(s / 1e3, t / 1e3) for _, s, t, _ in self.ops]) / 1e6

    def span_ms(self, name: str) -> list[float]:
        return [(t - s) / 1e6 for s, t in self.spans.get(name, [])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost benchmark span the host was in
        when the gap began."""
        by_name = defaultdict(float)
        for n, s, t, _ in self.ops:
            by_name[_short(n)] += (t - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for _, s, t, _ in self.ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = t if end is None else max(end, t)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[self._host_at(a), (b - a) / 1e9] for a, b in gaps[:top]]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}

    def _host_at(self, t) -> str:
        """The innermost benchmark span and host operation running at t."""
        inside = [(s[1] - s[0], n) for n, v in self.spans.items() for s in v if s[0] <= t <= s[1]]
        ops = [(b - a, n) for a, b, n in self.host if a <= t <= b]
        where = min(inside)[1] if inside else "outside the benchmark's spans"
        return f"{where}: {min(ops)[1]}" if ops else where


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = name.find(">(")
    return (name[:cut + 1] if cut >= 0 else name.split("(")[0])[:120]


def _busy_us(spans) -> float:
    """Length of the union of the intervals, in the intervals' unit."""
    busy, end = 0.0, -float("inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy
