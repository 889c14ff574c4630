"""Median host ms per step in the program's span ``stt:train.update``: the
optimizer step and the BatchNorm statistics' write, over the traced steps."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "train.update")
