"""Median host ms per step in the program's span ``stt:train.input``: the
wire batch's copies to the card, its dequantization and the augmentation,
over the traced steps."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "train.input")
