"""Median per frame of the host ms summed over the program's spans
``stt:mit.stage1`` .. ``stt:mit.stage4`` (``fused_forward``'s four stages,
each from its patch embed to its norm) inside that frame's
``stt:session.features``, over the traced frames."""

from harness.program_spans import median_inside_ms

STAGES = tuple(f"mit.stage{s}" for s in range(1, 5))


def read(view):
    return median_inside_ms(view.timeline, "session.features", STAGES)
