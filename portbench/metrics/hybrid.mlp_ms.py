"""Device ms per video of the operations launched inside the program's span
``stt:jamba.mlp`` (``models/jamba.py``: each layer's pre-MLP norm, SwiGLU MLP
and residual add), over the traced videos; None where the program has no
such span."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "jamba.mlp", view.counts.get("videos", 0))
