"""Median host time of the benchmark's span around
``OnlineSession.features`` (the feature leg), ms, over the traced frames.
The traced run waits for the leg's device work inside the span."""

import statistics


def read(view):
    ms = view.timeline.span_ms("features")
    return statistics.median(ms) if ms else None
