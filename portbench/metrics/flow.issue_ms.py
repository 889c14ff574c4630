"""Median host ms per batch in the program's span ``stt:flow.forward``
(``models/raft.py::make_flow_fn``): the mapping and padding on the card and
the issue of RAFT's encoders, 20 refinement iterations and upsampling, which
the flows' copy to the host then waits out, over the traced batches."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "flow.forward")
