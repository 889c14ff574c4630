"""Device ms per batch of the operations launched inside the program's span
``stt:flow.encode`` (``models/raft.py::RAFT.forward``): both encoders over
the batch's frames (the feature encoder at 2B, the context encoder at B),
the all-pairs correlation volume and its pyramid."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "flow.encode", view.counts.get("batches", 0))
