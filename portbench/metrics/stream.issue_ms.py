"""Median host ms per frame in the program's span ``stt:session.features``:
the feature leg's issue, without the wait for its device work that the
benchmark's ``features`` span holds in a traced run (``stream.feature_ms``)."""

from harness.program_spans import median_ms


def read(view):
    return median_ms(view.timeline, "session.features")
