"""Jamba at AI21-Jamba2-3B's published widths on the card (28 layers, hidden
2560, bf16), weights drawn on the card as the benchmark draws them
(``portbench/traffic/hybrid_video.py::build_temporal``). Every case is
marked ``cuda`` and skips without a card; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_jamba_card.py -m cuda

- ``predict_video`` (Jamba, then the refiner) on one video of T = 2048
  stored features against ``portbench/reference/jamba.py`` and the
  refiner's reference in fp32 (TF32 off) on the same weights, within the
  ``jamba2-3b.video`` cell's ``output_gap`` limit, as the cell compares,
  with one scan launch per Mamba layer;
- the session's temporal leg (``TemporalGraph`` over ``OnlineJamba`` and
  the refiner) over 64 frames with a reset halfway equals the eager steps
  bit for bit, outputs and states (the K/V caches and the frame count among
  them), one capture and the rest replays.
"""

import os
import sys

import pytest
import torch
from torch.utils import _pytree as pytree

from surgical_tpu_torch.core.config import RefinerConfig
from surgical_tpu_torch.kernels import selective_scan as scan_kernel
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving import temporal_graph as tg
from surgical_tpu_torch.serving.online import OnlineJamba, OnlineRefiner
from surgical_tpu_torch.train.refiner import predict_video
from surgical_tpu_torch.utils.trace import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import compare, files, program  # noqa: E402
from traffic import hybrid_video  # noqa: E402

CELL = "jamba2-3b.video"
SEED = 2**35 + 17


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel and CUDA graphs have no CPU build")


def _model():
    conf = files.config(files.workload(CELL)["config"])
    model, sd = hybrid_video.build_temporal(conf, SEED, torch.device("cuda"))
    return model, sd, conf


@pytest.mark.cuda
def test_published_widths_against_reference():
    """The cell's comparison on one video: ``predict_video`` (Jamba, then
    the refiner) against the references of both."""
    _needs_card()
    model, sd, conf = _model()
    refiner, sd_r = program.refiner(conf, SEED, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    lfb = torch.randn(2048, 2048, generator=g, device="cuda").abs() * 0.5
    launches = scan_kernel.selective_scan.launches
    got = predict_video(model, refiner, lfb)
    assert scan_kernel.selective_scan.launches - launches == 26
    with torch.no_grad(), compare.precision(False):
        want = hybrid_video.pipeline(sd, conf["temporal"]["config"], sd_r,
                                     conf["refiner"]["config"], lfb)
    gap = compare.row_gap(got, want)
    print(f"output_gap at T = 2048: {gap!r}")
    assert torch.isfinite(got).all()
    assert gap < files.workload(CELL)["limits"]["output_gap"]


@pytest.mark.cuda
def test_graphed_leg_equals_eager_across_a_reset():
    _needs_card()
    model, _, _ = _model()
    temporal = OnlineJamba(model)
    refiner = OnlineRefiner(RefinementTransformer(RefinerConfig(), seed=5, device="cuda"))
    leg = tg.TemporalGraph(temporal, refiner)
    n = 64
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    fs = torch.randn(n, 2048, generator=g, device="cuda").abs() * 0.5
    before = counters()["temporal_graph"]
    state, rstate = temporal.init_state(), refiner.init_state()
    eager, reager = temporal.init_state(), refiner.init_state()
    for t in range(n):
        if t == n // 2:
            state, rstate = temporal.init_state(), refiner.init_state()
            eager, reager = temporal.init_state(), refiner.init_state()
        state, rstate, got = leg(state, rstate, fs[t])
        eager, reager, want = tg.eager_leg(temporal, refiner, eager, reager, fs[t])
        assert torch.equal(got, want), t
        for a, b in zip(pytree.tree_leaves((state, rstate)), pytree.tree_leaves((eager, reager)),
                        strict=True):
            assert torch.equal(a, b), t
    after = counters()["temporal_graph"]
    assert {k: after[k] - before[k] for k in after} == {"captures": 1, "replays": n - 1,
                                                        "eager": 1}
    assert int(state[1]) == n - n // 2
