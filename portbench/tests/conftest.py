"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Tests that need an NVIDIA card carry the ``cuda`` marker and decide inside
the test whether one is present."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips with a reason where there is none")
