"""Device ms per video of the operations launched inside the program's span
``stt:predict.temporal`` (the temporal model's call in ``predict_video``), over the
traced videos."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "predict.temporal", view.counts.get("videos", 0))
