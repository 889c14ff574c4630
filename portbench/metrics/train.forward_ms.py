"""Median host ms per step in the program's span ``stt:train.forward``: the
graph's forward in train mode and the loss, over the traced steps."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "train.forward")
