"""The readers of the program's own spans (``harness/program_spans.py`` and
the ``program_span`` metrics that read ``stt:`` host events): known values
on a synthetic timeline, nothing on a timeline without the spans (a program
that lacks them), and values from a tiny traced run on the CPU."""

from types import SimpleNamespace

import pytest
import torch

import tiny
from harness import core, files
from harness.trace import Timeline

MS = 1_000_000  # ns
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """What ``Timeline`` reads of a profiler event."""

    def __init__(self, name, start_ms, end_ms, device=CPU, corr=0):
        self._name, self._device, self._corr = name, device, corr
        self._start, self._dur = int(start_ms * MS), int((end_ms - start_ms) * MS)

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._name.startswith(("stt:", "portbench:"))


def host(name, a, b):
    return Event(name, a, b)


def launched(corr, at_ms, op_ms):
    """A kernel launched at ``at_ms`` that ran for ``op_ms`` later on."""
    return [Event("cudaLaunchKernel", at_ms, at_ms + 0.01, corr=corr),
            Event(f"kernel{corr}", 1000 + corr, 1000 + corr + op_ms, device=CUDA, corr=corr)]


def background():
    """Events every timeline has: aten ops, a benchmark span, device work."""
    return [host("aten::copy_", 0, 3), host("portbench:unit", 0, 400),
            Event("portbench:unit", 0, 400, device=CUDA), *launched(99, 300, 1.0)]


def synthetic():
    return Timeline(synthetic_events(), window_s=1.0)


def synthetic_events():
    ev = background()
    for name, spans in {"extract.h2d": [(0, 10), (50, 54), (80, 86)],
                        "extract.forward": [(10, 30), (54, 70), (86, 98)],
                        "extract.drain": [(30, 31), (70, 72), (98, 101)],
                        "train.input": [(0, 2), (10, 11)],
                        "train.forward": [(2, 5), (11, 12)],
                        "train.backward": [(5, 9), (12, 18)],
                        "train.update": [(9, 10), (18, 20)],
                        "gc.gen2": [(3, 4)]}.items():
        ev += [host("stt:" + name, a, b) for a, b in spans]
    # two frames: stages 1+2+3+4 ms and 1+1+2+2 ms, prompts 2 and 1 ms; a
    # stage span outside any frame is not counted
    ev += [host("stt:session.features", 100, 130), host("stt:session.features", 200, 220),
           host("stt:mit.prompts", 101, 103), host("stt:mit.prompts", 201, 202)]
    for frame, lengths in ((104, (1, 2, 3, 4)), (203, (1, 1, 2, 2))):
        t = frame
        for s, n in enumerate(lengths, 1):
            ev.append(host(f"stt:mit.stage{s}", t, t + n))
            t += n
    ev.append(host("stt:mit.stage1", 300, 350))
    # two videos: kernels launched in the temporal spans run 2 + 4 ms, in the
    # refiner spans 3 ms; the kernel launched at 300 ms is in neither
    ev += [host("stt:predict.temporal", 500, 505), host("stt:predict.refiner", 505, 509),
           host("stt:predict.temporal", 600, 610), host("stt:predict.refiner", 610, 611),
           *launched(1, 501, 2.0), *launched(2, 601, 4.0), *launched(3, 506, 3.0)]
    # a span's range on the device's timeline is a user annotation
    ev.append(Event("stt:extract.forward", 10, 30, device=CUDA))
    return ev


WANT = {"extract.h2d_host_ms": 6.0, "extract.issue_ms": 16.0, "extract.drain_ms": 2.0,
        "train.input_ms": 1.5, "train.forward_ms": 2.0, "train.backward_ms": 5.0,
        "train.update_ms": 1.5, "stream.issue_ms": 25.0, "stream.stages_ms": 8.0,
        "stream.prompts_ms": 1.5, "video.temporal_ms": 3.0, "video.refiner_ms": 1.5}
DEVICE = ("video.temporal_ms", "video.refiner_ms")


def test_the_readers_are_the_benchmarks_program_spans():
    spans = {m["name"]: m for m in files.benchmark()["per_layer"]
             if m["source"] == "program_span" and m["name"] in WANT}
    assert set(spans) == set(WANT)
    for m in spans.values():
        assert m["unit"] == "ms" and m["better"] == "lower" and len(m["workloads"]) == 1


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_known_spans(metric):
    view = SimpleNamespace(timeline=synthetic(), counts={"videos": 2})
    got = files.metric_reader(metric)(view)
    assert got == pytest.approx(WANT[metric], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_program_spans_reads_nothing(metric):
    view = SimpleNamespace(timeline=Timeline(background(), window_s=1.0), counts={"videos": 2})
    assert files.metric_reader(metric)(view) is None


def test_program_spans_are_host_events_not_launches_or_device_operations():
    tl = synthetic()
    assert len(tl.ops) == 4 and tl.linked == 4
    assert not any(n.startswith("stt:") for n in tl.spans)
    made = [e for e in synthetic_events() if e.name().startswith("stt:")]
    assert sum(1 for _, _, n in tl.host if n.startswith("stt:")) == len(made) - 1 == 35


@pytest.mark.parametrize("cell", ["b3-mstcn.extract", "b3-mstcn.train", "b0-mamba.stream",
                                  "b0-mamba.video"])
def test_tiny_traced_run_reports_the_host_readers(cell):
    ctx = tiny.context(cell, trace=True)
    ctx.workload["trace_units"] = 2
    bench = files.benchmark()
    e2e = [m["name"] for m in files.end_to_end_metrics(bench, cell)]
    per_layer = files.per_layer_metrics(bench, cell, e2e)
    r = core.run_cell(ctx, 0.0, 0.0, per_layer=per_layer, max_units=1)
    assert r["correct"], r["checks"]
    mine = [m["name"] for m in per_layer if m["name"] in WANT]
    host = [n for n in mine if n not in DEVICE]
    assert all(r["metrics"][n]["value"] > 0 for n in host), r["metrics"]
    assert not [n for n in DEVICE if n in r["metrics"]]  # no device operation on the CPU
    assert len(mine) == {"b3-mstcn.extract": 3, "b3-mstcn.train": 4, "b0-mamba.stream": 3,
                         "b0-mamba.video": 2}[cell]
