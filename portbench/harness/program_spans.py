"""The program's own spans in a traced stretch.

The program marks the layer boundaries of its hot paths with host events
named ``stt:<name>`` (``surgical_tpu_torch/utils/trace.py``), recorded only
while a profiler runs. They are neither launches nor the benchmark's spans,
so ``Timeline`` keeps them in ``host`` as ``(start ns, end ns, name)``, on
the clock of the device operations and their launches. A program without
them (an older checkout) leaves every function here with nothing to read:
each then returns None.
"""

from __future__ import annotations

import bisect
import statistics

PREFIX = "stt:"


def intervals(tl, name: str) -> list[tuple[int, int]]:
    """The host intervals of the program's span ``name``, in start order."""
    full = PREFIX + name
    return sorted((s, t) for s, t, n in tl.host if n == full)


def median_ms(tl, name: str):
    """Median host ms of the span ``name``, one reading per span."""
    spans = intervals(tl, name)
    return statistics.median((t - s) / 1e6 for s, t in spans) if spans else None


def median_inside_ms(tl, outer: str, names) -> float | None:
    """Median over the ``outer`` spans of the host ms summed over the spans
    in ``names`` that lie inside each."""
    outers = intervals(tl, outer)
    inner = [iv for n in names for iv in intervals(tl, n)]
    if not outers or not inner:
        return None
    return statistics.median(sum(t - s for s, t in inner if a <= s and t <= b) / 1e6
                             for a, b in outers)


def device_ms_per(tl, name: str, units: int) -> float | None:
    """Device ms, per unit of ``units``, of the operations whose launch fell
    in a span ``name``."""
    spans = intervals(tl, name)
    if not spans or not units:
        return None
    starts = [s for s, _ in spans]

    def launched_inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return t is not None and i >= 0 and spans[i][1] >= t

    ops = [o for o in tl.ops if launched_inside(o[3])]
    return tl.device_s(ops) * 1e3 / units if ops else None
