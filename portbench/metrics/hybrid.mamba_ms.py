"""Device ms per video of the operations launched inside the program's span
``stt:jamba.mamba`` (``models/jamba.py``: each Mamba layer's input norm, its
mixer with the dt, B and C norms and the selective scan, and the residual
add), over the traced videos; None where the program has no such span."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "jamba.mamba", view.counts.get("videos", 0))
