"""The benchmark's parts are found by name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import re
import shutil

import pytest

import tiny
from harness import files

BENCH = files.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_workload_file_by_name(cell):
    w = files.workload(cell)
    entry = next(e for e in BENCH["workloads"] if e["name"] == cell)
    assert w["config"] == entry["config"] and w["why"] == entry["why"]
    assert w["chips"] == entry["chips"] == 1
    files.config(w["config"])
    traffic_mod = files.traffic(w["traffic"]["kind"])
    for fn in ("setup", "unit", "end_to_end", "counts", "least_s", "release", "check"):
        assert callable(getattr(traffic_mod, fn))
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_by_name(metric):
    assert callable(files.metric_reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    c = files.config(config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert c["reduced"] == entry["reduced"] == []
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["why"] == c["why"] and len(entry["why"]) <= 200
    for part in ("backbone", "temporal", "refiner"):
        files.resolve(c[part]["constructor"])
        files.resolve(c[part]["config_class"])
    assert len(c["source"]) <= 200


def test_new_workload_file_is_taken_up(tmp_path):
    """A cell added as one new file is found with no edit to another."""
    copy = tmp_path / "portbench"
    shutil.copytree(files.BENCH_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads((copy / "workloads" / "b0-mamba.video.json").read_text())
    new["traffic"]["video_lengths"] = [1700, 2400]
    new["why"] = "a second mix of the video kind"
    (copy / "workloads" / "b0-mamba.video-short.json").write_text(json.dumps(new))
    w = files.workload("b0-mamba.video-short", bench_dir=copy)
    assert w["traffic"]["video_lengths"] == [1700, 2400]
    assert w["name"] == "b0-mamba.video-short"
    assert files.traffic(w["traffic"]["kind"], bench_dir=copy).__name__.endswith("video")


def test_per_layer_selection():
    picked = files.per_layer_metrics(BENCH, "b0-mamba.video", ["video_ms_p95", "setup_s"])
    assert {m["name"] for m in picked} == {"video.scan_roofline", "video.ops_per_video",
                                          "video.mfu", "video.idle"}
    extra = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "x.y", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "video_ms_p95"}])
    assert "x.y" in {m["name"] for m in files.per_layer_metrics(extra, "b0-mamba.video",
                                                                 ["video_ms_p95"])}


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for c in m["workloads"]:
            assert m["moves"] in [x["name"] for x in files.end_to_end_metrics(BENCH, c)]
        if m["unit"] == "%":
            assert m["name"].endswith(("roofline", "mfu", "idle"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        reported = [m["name"] for m in files.end_to_end_metrics(BENCH, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert files.per_layer_metrics(BENCH, w["name"], reported)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_tiny_copies_keep_the_cells_checks():
    for cell in tiny.CELLS:
        assert tiny.tiny_workload(cell)["limits"] == files.workload(cell)["limits"]
