"""Median host ms per batch in the program's span ``stt:extract.h2d``:
the host held while ``make_raw_feature_fn`` copies the pageable wire batch
to the card (``extract.h2d_ms`` is the device's side of the same copies),
over the traced batches."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "extract.h2d")
