"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics;
``portbench/workloads/<cell>.json``, ``portbench/configs/<config>.json``,
``portbench/traffic/<kind>.py`` and ``portbench/metrics/<metric>.py`` hold
each one's own part. A later change adds a cell, a configuration or a
metric by adding its file; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell's own file: its configuration, traffic kind and parameters,
    end-to-end metric and the limits of its output check."""
    w = _json(bench_dir / "workloads" / f"{name}.json")
    w.setdefault("name", name)
    return w


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    c = _json(bench_dir / "configs" / f"{name}.json")
    c.setdefault("name", name)
    return c


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (``extract.h2d_ms.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    mod = load_module(bench_dir / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def per_layer_metrics(bench: dict, cell: str, e2e_names) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, or that
    list no cells and move one of its end-to-end metrics."""
    out = []
    for m in bench.get("per_layer", []):
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e_names:
            out.append(m)
    return out


def end_to_end_metrics(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench.get("end_to_end", [])
            if "workloads" not in m or cell in m["workloads"]]


def resolve(spec: str):
    """``"package.module:Name"`` -> the object."""
    mod, _, attr = spec.partition(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj
