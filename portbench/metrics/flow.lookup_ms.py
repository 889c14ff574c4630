"""Device ms per batch of the operations launched inside the program's spans
``stt:flow.lookup`` (``models/raft.py::RAFT.forward``): the radius-4 window
sampled from every pyramid level around the current flow (the tent-weight
contractions), summed over the batch's refinement iterations."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "flow.lookup", view.counts.get("batches", 0))
