"""Median host time of the benchmark's span around
``OnlineSession.advance`` and its host copy (the temporal and refiner
leg), ms, over the traced frames."""

import statistics


def read(view):
    ms = view.timeline.span_ms("advance")
    return statistics.median(ms) if ms else None
