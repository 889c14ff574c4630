"""Median host ms per batch in the program's span ``stt:extract.drain``:
how long ``extract_features`` waits for the previous batch's features to
reach pinned host memory, and writes them out, over the traced batches."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "extract.drain")
