"""Device ms per video of the operations launched inside the program's span
``stt:jamba.attention`` (``models/jamba.py``: each attention layer's input
norm, causal multi-query attention and residual add), over the traced
videos; None where the program has no such span."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "jamba.attention", view.counts.get("videos", 0))
