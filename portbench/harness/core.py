"""One run of one cell: set-up, the measured window, the output check and
the result line.

The traffic module of the cell's kind (``traffic/<kind>.py``) provides:

- ``setup(ctx) -> state``: builds the program's objects from the seed and
  warms up every shape the window uses;
- ``unit(state, i) -> record``: one timed unit of work (a batch, a step, a
  frame, a video), the record holding ``n`` (frames done) and ``ms`` (its
  host time) and what the check needs;
- ``end_to_end(state, records, window_s) -> {metric: value}``;
- ``counts(state, records) -> {"frames": .., "<unit>s": ..}`` and
  ``least_s(state, records)``: the reference's work in those records at
  the card's peaks (for the ``mfu`` readers);
- ``release(state)``: drops the program's state before the check;
- ``check(state, records, ctx) -> [(name, value, limit)]``: the outputs
  against the plain reference.

The window runs units until ``seconds`` have passed; a rate is all the
window's work over all its time, a tail is over all its units. With
``trace`` the first ``trace_units`` units of the window run under the
profiler, and the per-layer readers read that stretch; the rest of the
window runs untraced (at least one unit), and the ``mfu`` readers read
that rest, which the profiler does not slow. A unit that fails raises:
the run then ends without a result, so ``failed`` is always 0.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from harness import files
from harness.trace import Tracer

BANNED_MODULES = ("jax", "jaxlib", "flax", "surgical_tpu")


def banned_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED_MODULES))


@dataclass
class Context:
    seed: int
    device: torch.device
    config: dict
    workload: dict
    trace: bool = False
    tracing: bool = False  # inside the traced stretch of a traced run
    control: bool = False  # compare the reference one precision lower in the program's place
    log: list = field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.workload["traffic"]

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times a part of set-up (printed with the run's summary)."""
        t = time.perf_counter()
        yield
        sync(self.device)
        self.log.append((name, time.perf_counter() - t))


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(ctx: Context, seconds: float, t_process: float, traffic_mod=None,
             per_layer=(), e2e_names=None, max_units=None) -> dict:
    """Everything of one run but the printing: the result as a dict.
    ``max_units`` (tests) ends the window after that many units instead of
    after ``seconds``."""
    traffic_mod = traffic_mod or files.traffic(ctx.params["kind"])
    dev = ctx.device
    state = traffic_mod.setup(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_process
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records, ends = [], []
    tracer = None
    trace_units = int(ctx.workload.get("trace_units", 0)) if ctx.trace else 0
    rest_from, rest_t0 = 0, None  # the untraced rest of a traced window
    t0 = time.perf_counter()
    i = 0
    while True:
        if tracer is None and trace_units:
            tracer = Tracer(dev).__enter__()
            ctx.tracing = True
        records.append(traffic_mod.unit(state, i))
        ends.append(time.perf_counter())
        i += 1
        if tracer is not None and i == trace_units:
            tracer.__exit__(None, None, None)
            ctx.tracing = False
            trace_units = 0
            rest_from, rest_t0 = i, time.perf_counter()
        done = i >= max_units if max_units else time.perf_counter() - t0 >= seconds
        if done and trace_units == 0 and i > rest_from:
            break
    sync(dev)
    t_end = time.perf_counter()
    window_s = t_end - t0
    starts = [rest_t0 if rest_t0 is not None else t0] + ends[rest_from:-1]
    result = {"setup_s": setup_s, "window_s": window_s, "units": len(records),
              "attempted": len(records),
              "notes": window_thirds(records[rest_from:], starts, ends[rest_from:])}
    if ctx.trace:
        tl = tracer.timeline()
        traced, rest = records[:rest_from], records[rest_from:]
        view = View(tl, tracer, traffic_mod.counts(state, traced),
                    traffic_mod.least_s(state, rest), t_end - rest_t0, ctx)
        result["dilation"] = (statistics.median(r["ms"] for r in traced)
                              / statistics.median(r["ms"] for r in rest))
        metrics = {}
        for m in per_layer:
            value = files.metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        result["busy_s"] = tl.busy_s()
        result["traced_window_s"] = tl.window_s
        result["breakdown"] = tl.breakdown()
        result["linked_ops"] = (tl.linked, len(tl.ops))
    else:
        e2e = traffic_mod.end_to_end(state, records, window_s)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in (e2e_names or [])}
        result["metrics"] = {k: {"value": float(v), "unit": units.get(k, "")}
                             for k, v in e2e.items() if not units or k in units}
    if dev.type == "cuda":
        result["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    traffic_mod.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result["checks"] = traffic_mod.check(state, records, ctx)
    result["check_s"] = time.perf_counter() - t_check
    result["correct"] = all(v <= lim for _, v, lim in result["checks"])
    return result


def window_thirds(records, starts, ends) -> str:
    """Frames/s and the 95th percentile of unit time in each third of the
    (untraced) window: whether a run's pace drifts within it or is set
    once per process."""
    k = len(records) // 3
    if k < 2:
        return ""
    parts = [slice(0, k), slice(k, 2 * k), slice(2 * k, len(records))]
    fps = [sum(r["n"] for r in records[p]) / (ends[p][-1] - starts[p][0]) for p in parts]
    p95 = [statistics.quantiles([r["ms"] for r in records[p]], n=20)[-1] for p in parts]
    return ("by thirds of the untraced window: frames/s "
            + " / ".join(f"{v:.6g}" for v in fps) + ", unit ms p95 "
            + " / ".join(f"{v:.6g}" for v in p95))


class View:
    """What a per-layer reader reads: the traced stretch's ``timeline``, the
    kernel spans' summed least times (``bounds``) and the stretch's
    ``counts``; the reference's least time at peak for the work of the
    untraced rest of the window (``untraced_least_s``) and that rest's wall
    time (``untraced_s``); and the cell's ``params``."""

    def __init__(self, timeline, tracer, counts, untraced_least_s, untraced_s, ctx):
        self.timeline = timeline
        self.bounds = dict(tracer.bounds)
        self.counts = counts
        self.untraced_least_s = untraced_least_s
        self.untraced_s = untraced_s
        self.params = ctx.params
        self.window_s = timeline.window_s


def main(argv=None, t_process=None) -> int:
    import argparse
    import json

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = files.benchmark()
    wl = files.workload(args.workload)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    chips = cell["chips"] if cell else wl.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(f"portbench: {smi_line()}", file=sys.stderr)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # the program's default; the reference turns it off
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Context(args.seed, dev, files.config(wl["config"]), wl, trace=bool(args.trace))
    e2e = files.end_to_end_metrics(bench, args.workload)
    per_layer = files.per_layer_metrics(bench, args.workload, [m["name"] for m in e2e])
    res = run_cell(ctx, args.seconds, t_process, per_layer=per_layer, e2e_names=e2e)

    found = banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    checks = {n: {"value": v, "limit": lim} for n, v, lim in res["checks"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["traced_window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": 0,
            "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    print(f"portbench: {args.workload} seed {args.seed}: {res['units']} units in "
          f"{res['window_s']:.3f} s, set-up {res['setup_s']:.3f} s, check "
          f"{res['check_s']:.3f} s" + (f", device ops linked to a launch "
                                       f"{res['linked_ops'][0]} of {res['linked_ops'][1]}"
                                       if args.trace else "")
          + (f", traced units' median time {res['dilation']:.4f} x the untraced"
             if args.trace else ""), file=sys.stderr)
    print("portbench: set-up " + ", ".join(f"{n} {t:.3f} s" for n, t in ctx.log),
          file=sys.stderr)
    if res["notes"]:
        print(f"portbench: {res['notes']}", file=sys.stderr)
    for n, v, lim in res["checks"]:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0

