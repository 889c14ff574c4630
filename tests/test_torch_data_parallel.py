"""Data parallelism in the port on the CPU over gloo ranks: extraction over
a group against one process on the shards, the batch-sharded backbone step
against the one-rank step on the global batch, ``extract-features`` under
``python -m torch.distributed.run``, the refusals and ``dryrun_multirank``.

The n-rank results are held to the port's own one-rank computations, which
the other test files hold to JAX (``test_torch_backbone_trainer.py`` the
step, ``test_torch_extract_cli.py`` extraction): extraction bit for bit
(each rank's shard is the one-process batch, the same ops at the same
shapes), the fp32 step within rel L2 1e-6 (the sharded BatchNorm sums and
gradient sums add in another order). The spawned ranks import no JAX.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from surgical_tpu_torch import cli
from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.data.datasets import FrameCache, RankSlice
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.parallel import dryrun, mesh
from surgical_tpu_torch.train.extract import make_raw_feature_fn

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

TINY = BackboneConfig.preset("tiny")
TINY_HEAD = HeadConfig(embedding_dim=32, hidden=16)
EXTRACT = dict(frames=21, batch=8, size=64)  # 2 batches of 8 and a ragged tail of 5
STEP_BOUND = dryrun.STEP_BOUND


@pytest.fixture(scope="module")
def two_ranks():
    """One spawn of two gloo ranks: tiny-preset extraction with a ragged
    tail, then the batch-sharded step at the dry run's dims, then
    extraction with int8 weights."""
    step = next(kw for leg, kw in dryrun.dryrun_legs(2, "cpu") if leg is dryrun.step_leg)
    legs = [(dryrun.extract_leg, dict(cfg=TINY, head_cfg=TINY_HEAD, seed=1, **EXTRACT)),
            (dryrun.step_leg, step),
            (dryrun.extract_leg, dict(cfg=TINY, head_cfg=TINY_HEAD, seed=2, weight_quant="int8",
                                      **EXTRACT))]
    return dryrun.spawn(dryrun.run_legs, 2, legs, device="cpu")


def test_extraction_two_ranks_equals_one_rank_on_the_shards(two_ranks):
    ext = two_ranks[0][0]
    assert ext["shape"] == (EXTRACT["frames"], TINY_HEAD.embedding_dim)
    assert ext["rank_batch"] == EXTRACT["batch"] // 2 and ext["batches"] == 3
    assert ext["equal"], ext["max_abs"]


def test_int8_extraction_two_ranks_equals_one_rank_on_the_shards(two_ranks):
    """``weight_quant="int8"`` under a group: each rank dequantizes its own
    held weights and runs its shard, as one process does."""
    assert two_ranks[0][2]["equal"], two_ranks[0][2]["max_abs"]


def test_batch_that_does_not_divide_raises_on_every_rank(two_ranks):
    assert all(r[0]["odd_batch_raised"] for r in two_ranks)


def test_feature_fn_without_a_group_runs_alone_under_one(two_ranks):
    """``make_raw_feature_fn`` with no group keeps to this process while a
    group is initialised: the batch that does not divide over the ranks
    comes back whole on every rank."""
    assert all(r[0]["alone_rows"] == r[0]["odd"] for r in two_ranks)


def test_sharded_step_equals_one_rank_step(two_ranks):
    step = two_ranks[0][1]
    for key in ("loss_rel", "grad_rel_l2", "bn_rel_l2", "param_rel_l2"):
        assert step[key] <= STEP_BOUND, (key, step[key])
    assert step["bn_moved"] > 0 and step["grads"] > 0
    assert step["correct"][0] == step["correct"][1]
    # the ranks hold the same state after the step, bit for bit
    assert two_ranks[0][1]["hash"] == two_ranks[1][1]["hash"]


def test_dryrun_multirank_four_ranks():
    report = dryrun.dryrun_multirank(4, device="cpu")
    assert report["ranks"] == 4 and report["step_states_equal"] and report["extract_equal"]
    assert max(report["step"][k] for k in ("loss_rel", "grad_rel_l2", "bn_rel_l2",
                                           "param_rel_l2")) <= STEP_BOUND
    assert report["mstcn_max_abs"] <= dryrun.MSTCN_BOUND
    assert report["mamba_max_abs"] <= dryrun.MAMBA_BOUND


def test_extract_features_under_torchrun_equals_one_process(tmp_path):
    """``chip_smoke.phase_multirank_cli`` at the tiny preset: two gloo ranks
    at batch 8 against one process at batch 4, store by store bit for bit."""
    rng = np.random.default_rng(0)
    root, work = str(tmp_path / "root"), str(tmp_path / "work")
    chip_smoke._write_phase_annotations(root, (13, 10, 9, 14), rng)
    assert cli.main(["prepare-data", "--root", root, "--out", work, "--num-videos", "4",
                     "--scheme", "smoke"]) == 0
    for split in ("train", "val", "test"):
        labels = np.load(os.path.join(work, "index", f"{split}_labels.npy"))
        FrameCache.build(chip_smoke._WireFrames(len(labels), rng, labels),
                         os.path.join(work, "cache", split))
    evp = str(tmp_path / "evp.pth")
    torch.save(MiTEVP(TINY, TINY_HEAD, seed=5, device="cpu").state_dict(), evp)
    res = chip_smoke.phase_multirank_cli(
        str(tmp_path), {"work": work, "cache_root": os.path.join(work, "cache"), "evp": evp},
        model_flags=["--variant", "tiny"], device="cpu", backend="gloo", batch=8)
    assert res["splits"] == ["test", "train", "val"]
    assert all(len(res["launches"][s]) == 2 for s in res["splits"])


@pytest.mark.parametrize("argv", [
    ["predict", "--work", "w", "--device", "cpu"],
    ["train-backbone", "--work", "w", "--device", "cpu"],
    ["train-temporal", "--work", "w", "--device", "cpu"],
    ["export-serving", "--out", "o", "--device", "cpu"],
    ["reference-parity", "--root", "r", "--work", "w", "--evp", "e", "--temporal", "t",
     "--refiner", "f", "--device", "cpu"],
    ["selfcheck", "--device", "cpu"],
])
def test_other_verbs_refuse_under_several_ranks(monkeypatch, argv):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="only extract-features runs over several ranks"):
        cli.main(argv)


def test_init_from_env_without_a_world_starts_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_from_env("cpu") == (0, 1, torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_from_env("cpu", "gloo") == (0, 1, torch.device("cpu"))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", ["nccl", "mpi"])
def test_init_from_env_refuses_a_backend_it_cannot_run(monkeypatch, backend):
    """NCCL on the CPU, or an unknown backend, raises: nothing switches to
    gloo on its own."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError):
        mesh.init_from_env("cpu", backend)
    assert not torch.distributed.is_initialized()


class _CountingSource:
    """A ``frames`` source that records the indices it was asked for."""

    ant_cols = (8, 15)

    def __init__(self, n):
        rng = np.random.default_rng(3)
        self.wire = chip_smoke._WireFrames(n, rng)
        self.labels = self.wire.labels
        self.read = []

    def __len__(self):
        return len(self.labels)

    def frames(self, idx):
        self.read.append(list(idx))
        return self.wire.frames(np.asarray(idx))


@pytest.mark.parametrize("rank,chunk,read", [
    (0, range(0, 8), [[0, 1, 2, 3]]), (1, range(0, 8), [[4, 5, 6, 7]]),
    (0, range(8, 13), [[8, 9, 10, 11]]), (1, range(8, 13), [[12]]),
    (1, range(8, 11), [[8]]),  # the slice lies in the padding: one frame for the shapes
])
def test_rank_slice_reads_only_its_slice(rank, chunk, read):
    src = _CountingSource(13)
    idx = np.asarray(chunk)
    img, seg, flow, phase, ant = RankSlice(src, 8, rank, 2).frames(idx)
    assert src.read == read
    full = src.wire.frames(idx)
    lo, hi = 4 * rank, min(4 * rank + 4, len(idx))
    assert img.shape == full[0].shape and flow.dtype == np.float16
    for got, want in ((img, full[0]), (seg, full[1]), (flow, full[2])):
        np.testing.assert_array_equal(got[lo:hi], want[lo:hi])
        assert not got[:lo].any() and not got[hi:].any()
    np.testing.assert_array_equal(phase, full[3])
    np.testing.assert_array_equal(ant, full[4])


def test_rank_slice_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError):
        RankSlice(_CountingSource(4), 7, 0, 2)


def test_feature_fn_alone_is_rank_zero():
    fn = make_raw_feature_fn(MiTEVP(TINY, TINY_HEAD, device="cpu"))
    assert fn.rank == 0
