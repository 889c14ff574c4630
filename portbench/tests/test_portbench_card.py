"""Each cell as the benchmark runs it, on the card: a short window, then
the result line's contract. Skips where there is no CUDA card."""

import json
import subprocess
import sys

import pytest
import torch

import tiny
from harness import files


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
                          cwd=files.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    bench = files.benchmark()
    e2e = [m["name"] for m in files.end_to_end_metrics(bench, cell)]
    want = ([m["name"] for m in files.per_layer_metrics(bench, cell, e2e)] if trace else e2e)
    assert sorted(line["metrics"]) == sorted(want)
    for m in line["metrics"].values():
        assert m["value"] > 0
        if m["unit"] == "%":
            assert m["value"] <= 100
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
