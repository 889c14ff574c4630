"""The ``raft-things.flow`` cell at tiny size on the CPU: the run is correct
as committed and not with the timed path broken underneath (one pair's
flow altered, a refinement iteration left out); a traced run reads the
flow function's host span and the device readers read nothing without a
card; the reference imports nothing of JAX, the JAX package or the
program; the per-layer readers on a synthetic timeline. The TF32 control
needs the card (``calibrate.py``)."""

import copy
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import tiny  # noqa: F401  (puts the benchmark's directories on sys.path)
from harness import core, files
from harness.trace import Timeline
from test_portbench_program_spans import background, host, launched

CELL = "raft-things.flow"
SEED = 2**31 + 23


def context(**kw) -> core.Context:
    w = copy.deepcopy(files.workload(CELL))
    w["traffic"].update(batch=3, size=60, max_shift=4, iters=2, pool_batches=2)
    w["trace_units"] = 0
    return core.Context(SEED, torch.device("cpu"), files.config(w["config"]), w, **kw)


def run(units=3, **kw):
    return core.run_cell(context(**kw), 0.0, 0.0, max_units=units)


def test_tiny_flow_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] == r["units"] == 3
    assert set(r["metrics"]) == {"setup_s", "extract_fps"}
    assert [c[0] for c in r["checks"]] == ["flow_gap"]


def test_the_cells_limits_and_files():
    w = files.workload(CELL)
    assert set(w["limits"]) == {"flow_gap"} and w["traffic"]["kind"] == "flow"
    c = files.config(w["config"])
    assert c["reduced"] == [] and c["dtype"] == {"raft": "float32"}
    assert files.resolve(c["raft"]["constructor"]).__name__ == "RAFT"


def _patch_flow_fn(monkeypatch, fault):
    from surgical_tpu_torch.models import raft

    orig = raft.make_flow_fn

    def factory(model):
        if fault == "fewer_iterations":
            model.iters -= 1
        fn = orig(model)

        def broken(a, b):
            out = fn(a, b)
            if fault == "altered":
                out[-1] *= 1.5
            return out
        return broken

    monkeypatch.setattr(raft, "make_flow_fn", factory)


@pytest.mark.parametrize("fault", ["altered", "fewer_iterations"])
def test_flow_fault_is_caught(monkeypatch, fault):
    _patch_flow_fn(monkeypatch, fault)
    r = run(units=2)
    assert not r["correct"], r["checks"]


def test_tiny_traced_run_reads_the_host_span():
    ctx = context(trace=True)
    ctx.workload["trace_units"] = 2
    bench = files.benchmark()
    e2e = [m["name"] for m in files.end_to_end_metrics(bench, CELL)]
    per_layer = files.per_layer_metrics(bench, CELL, e2e)
    assert {m["name"] for m in per_layer} == {"flow.encode_ms", "flow.lookup_ms",
                                              "flow.update_ms", "flow.issue_ms", "flow.mfu",
                                              "flow.idle"}
    r = core.run_cell(ctx, 0.0, 0.0, per_layer=per_layer, max_units=1)
    assert r["correct"], r["checks"]
    assert r["metrics"]["flow.issue_ms"]["value"] > 0 and r["metrics"]["flow.mfu"]["value"] > 0
    # no device operation on the CPU
    assert not {"flow.encode_ms", "flow.lookup_ms", "flow.update_ms", "flow.idle"} & set(
        r["metrics"])


def _timeline():
    """One batch: the encode span launches a 5-ms kernel, two iterations'
    lookups 1 + 2 ms, their updates 3 + 4 ms, the forward span 20 ms."""
    ev = background() + [host("stt:flow.forward", 10, 30), host("stt:flow.encode", 10, 12),
                         host("stt:flow.lookup", 12, 14), host("stt:flow.update", 14, 16),
                         host("stt:flow.lookup", 16, 18), host("stt:flow.update", 18, 20)]
    ev += [*launched(1, 11, 5.0), *launched(2, 13, 1.0), *launched(3, 15, 3.0),
           *launched(4, 17, 2.0), *launched(5, 19, 4.0)]
    return Timeline(ev, window_s=1.0)


@pytest.mark.parametrize("metric,want", [("flow.encode_ms", 5.0), ("flow.lookup_ms", 3.0),
                                         ("flow.update_ms", 7.0), ("flow.issue_ms", 20.0)])
def test_reader_on_known_spans(metric, want):
    view = SimpleNamespace(timeline=_timeline(), counts={"batches": 1})
    assert files.metric_reader(metric)(view) == pytest.approx(want, rel=1e-9)
    bare = SimpleNamespace(timeline=Timeline(background(), window_s=1.0), counts={"batches": 1})
    assert files.metric_reader(metric)(bare) is None  # a program without the spans


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path[:0] = ['portbench']\n"
            "from reference import raft\n"
            "from harness.core import banned_modules\n"
            "print(banned_modules(), sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'surgical_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=files.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] []"
