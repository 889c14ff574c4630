"""Device ms per batch of the operations launched inside the program's spans
``stt:flow.update`` (``models/raft.py::RAFT.forward``): the motion encoder,
the separable ConvGRU, the flow head and the mask head (fifteen convolutions),
summed over the batch's refinement iterations."""

from harness.program_spans import device_ms_per


def read(view):
    return device_ms_per(view.timeline, "flow.update", view.counts.get("batches", 0))
