"""Median host ms per batch in the program's span ``stt:extract.forward``:
the issue of the wire dequantization and the fused serving graph, over the
traced batches."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "extract.forward")
