"""The port's ``cli selfcheck --full`` on the CPU: the seven verbs of the
JAX CLI's whole-pipeline check (prepare-data, train-backbone on the flax
graph at the tiny variant without flow, extract-features, train-temporal,
train-refiner, predict, evaluate) over the synthetic Pillow-written corpus,
then its two learned-quality gates with the JAX margins: the backbone's best
val accuracy and last train accuracy above 0.25, and the pipeline's frame
accuracy at least 0.75."""

import re

import numpy as np
import pytest
import torch

from surgical_tpu_torch import cli

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are many small ops, which several
    threads per process slow down when the suite runs its files in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VERBS = ("prepare-data", "train-backbone", "extract-features", "train-temporal",
         "train-refiner", "predict", "evaluate")


def test_cli_selfcheck_full_passes_its_gates(capsys):
    assert cli.main(["selfcheck", "--full", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [v for v in re.findall(r"^selfcheck --full: (\S+) done in [\d.]+ s$", out, re.M)] == list(VERBS)
    # each verb's own line
    for line in (r"^indexed 4 videos", r"^epoch 3: loss=", r"^best epoch: \d",
                 r"^restored backbone checkpoint step \d", r"^test: 21 frames at",
                 r"^epoch 39: train_loss=", r"^epoch 14: train_loss=", r'"acc_frame": ',
                 r"^Mean Accuracy: "):
        assert re.search(line, out, re.M), line
    bb = re.search(r"gate backbone: best val_acc ([\d.]+), final train_acc ([\d.]+) .*: pass$",
                   out, re.M)
    pipe = re.search(r"gate pipeline: test frame acc ([\d.]+) \(>= 0.75\): pass$", out, re.M)
    assert bb and float(bb[1]) > 0.25 and float(bb[2]) > 0.25
    assert pipe and float(pipe[1]) >= 0.75
    assert "SELFCHECK-FULL OK" in out


def test_chip_smoke_flax_graph_phase_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's flax-graph phase at the tiny preset on the CPU (64-px
    variants, batch 2, 250-px wire frames cropped to 224): the same variants,
    serving-graph cosine, training with no MiT-kernel launch, moved and
    frozen tensors, checkpoint round trip and gradient check as on the card;
    selfcheck --full is the test above."""
    import chip_smoke
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
    from surgical_tpu_torch.data.datasets import FrameCache

    monkeypatch.setattr(chip_smoke, "FG_B", 2)
    monkeypatch.setattr(chip_smoke, "FG_CPU_B", 1)
    rng = np.random.default_rng(0)
    caches = {name: FrameCache.build(chip_smoke._WireFrames(n, rng), str(tmp_path / name))
              for name, n in (("train", 4), ("val", 2), ("test", 2))}
    res = chip_smoke.phase_flax_graph(
        str(tmp_path), caches, BackboneConfig.preset("tiny", img_size=64, drop_path_rate=0.1),
        HeadConfig(embedding_dim=32, hidden=16, dropout=0.1), device="cpu", train_b=2,
        selfcheck=False)
    assert sorted(res["variants"]) == sorted(chip_smoke.FG_VARIANTS)
    assert all(v["rel_l2_fp32"] == 0.0 for v in res["variants"].values())
    assert not any(res["launches"].values()) and res["cosine_min"] > chip_smoke.FG_COS_BOUND
