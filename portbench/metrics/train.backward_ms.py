"""Median host ms per step in the program's span ``stt:train.backward``:
``zero_grad`` and ``loss.backward()``, the autograd engine's issue that the
calling thread waits out, over the traced steps."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "train.backward")
