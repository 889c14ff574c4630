"""Median per frame of the host ms in the program's span ``stt:mit.prompts``
(``fused_forward``'s prompt cascade) inside that frame's
``stt:session.features``, over the traced frames."""

from harness.program_spans import median_inside_ms


def read(view):
    return median_inside_ms(view.timeline, "session.features", ("mit.prompts",))
