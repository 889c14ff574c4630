"""Device ms per video of the operations launched inside the program's span
``stt:predict.refiner`` (the refiner's call in ``predict_video``), over the
traced videos."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "predict.refiner", view.counts.get("videos", 0))
