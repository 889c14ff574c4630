"""The port's serving leg on the CPU: checkpoint store, streaming models,
``cli predict`` / ``cli evaluate``, and the copied FeatureStore, held to the
JAX package and to the port's own offline path.

Stated bounds: streaming vs offline within 1e-5 (both fp32, the same
arithmetic a frame at a time; JAX pins 1e-6 for its own pair); ``cli
predict`` phase txts byte-identical to the JAX ``cmd_predict``'s on the same
index, FeatureStore and weights, with the refined logits within 1e-4.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu import cli as jax_cli
from surgical_tpu.core.checkpoint import CheckpointStore as JaxCheckpointStore
from surgical_tpu.core.config import MambaConfig, MSTCNConfig, RefinerConfig, TrainConfig
from surgical_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.train.refiner import RefinerTrainer
from surgical_tpu_torch import cli
from surgical_tpu_torch.core import config as port_config
from surgical_tpu_torch.core.checkpoint import CheckpointStore
from surgical_tpu_torch.data.feature_store import FeatureStore
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN, OnlineRefiner,
                                               run_pipeline)
from surgical_tpu_torch.train.extract import wire_dequant
from surgical_tpu_torch.train.refiner import predict_video

F_DIM = 32
LENGTHS, IDS = [37, 52], [41, 42]
ATOL_ONLINE, ATOL_LOGITS = 1e-5, 1e-4


# -- checkpoint store -----------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    cfg = port_config.MSTCNConfig(stages=2, layers=3, f_maps=8, f_dim=F_DIM)
    src = MultiStageTCN(cfg, seed=1, device="cpu")
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save(3, src.state_dict(), metrics={"val_acc": np.float32(0.25)},
               config={"f_maps": 8}, aux={"lr": torch.tensor(0.5)})
    store.save(7, {k: v.numpy() for k, v in src.state_dict().items()},
               metrics={"val_acc": 0.75})
    dst = store.restore(7, MultiStageTCN(cfg, seed=2, device="cpu"), device="cpu")
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    assert store.steps() == [3, 7] and store.latest_step() == 7
    assert store.best_step("val_acc") == 7 and store.best_step("val_acc", mode="min") == 3
    m = store.manifest(3)
    assert sorted(m) == ["config", "extra", "has_aux", "metrics", "step"]
    assert m["has_aux"] and not store.manifest(7)["has_aux"]
    aux = torch.load(tmp_path / "ckpt" / "step_00000003.aux.pt", weights_only=True)
    assert aux["lr"].item() == 0.5
    with pytest.raises(RuntimeError, match="Missing key"):
        store.restore(7, MultiStageTCN(port_config.MSTCNConfig(stages=3, layers=3, f_maps=8,
                                                               f_dim=F_DIM), device="cpu"),
                      device="cpu")


def test_checkpoint_queries_read_jax_manifests(tmp_path):
    """best_step / latest_step over manifests that the JAX store wrote."""
    jstore = JaxCheckpointStore(str(tmp_path / "ckpt"))
    for step, acc in ((0, 0.4), (1, 0.9), (2, 0.6)):
        jstore.save(step, {"w": np.zeros(3, np.float32)}, metrics={"val_acc": acc, "loss": 1 - acc})
    store = CheckpointStore(str(tmp_path / "ckpt"))
    assert store.steps() == jstore.steps() == [0, 1, 2]
    assert store.latest_step() == jstore.latest_step() == 2
    assert store.best_step("val_acc") == jstore.best_step("val_acc") == 1
    assert store.best_step("loss", mode="min") == jstore.best_step("loss", mode="min") == 1
    assert store.manifest(2) == jstore.manifest(2)


# -- streaming vs offline ---------------------------------------------------------

def _port_models(kind):
    if kind == "mamba":
        temporal = CausalMambaModel(port_config.MambaConfig(layers=3, d_model=16, d_state=8,
                                                            f_dim=F_DIM), seed=1, device="cpu")
        online = OnlineMamba(temporal)
    else:
        temporal = MultiStageTCN(port_config.MSTCNConfig(stages=2, layers=4, f_maps=16,
                                                         f_dim=F_DIM), seed=1, device="cpu")
        online = OnlineMSTCN(temporal)
    refiner = RefinementTransformer(port_config.RefinerConfig(f_maps=16, f_dim=F_DIM, len_q=6),
                                    seed=2, device="cpu")
    return temporal, online, refiner


@pytest.mark.parametrize("kind", ["mamba", "mstcn"])
def test_online_matches_offline(kind):
    temporal, online, refiner = _port_models(kind)
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal((45, F_DIM))
                             .astype(np.float32))
    with torch.no_grad():
        offline = temporal(feats[None])[:, 0]          # [S, T, out]
    streamed = online.run(feats)
    want = offline if kind == "mstcn" else offline[0]
    assert streamed.shape == want.shape
    torch.testing.assert_close(streamed, want, rtol=0, atol=ATOL_ONLINE)

    g = offline[-1]
    with torch.no_grad():
        refined = refiner(g, feats)
    torch.testing.assert_close(OnlineRefiner(refiner).run(g, feats), refined, rtol=0,
                               atol=ATOL_ONLINE)
    torch.testing.assert_close(run_pipeline(online, OnlineRefiner(refiner), feats),
                               predict_video(temporal, refiner, feats), rtol=0,
                               atol=ATOL_ONLINE)


def test_online_step_carries_state():
    """step() one frame at a time equals run() over the whole sequence."""
    temporal, online, _ = _port_models("mamba")
    feats = torch.from_numpy(np.random.default_rng(6).standard_normal((9, F_DIM))
                             .astype(np.float32))
    state, outs = online.init_state(), []
    for f in feats:
        state, y = online.step(state, f)
        outs.append(y)
    torch.testing.assert_close(torch.stack(outs), online.run(feats), rtol=0, atol=0)
    conv_buf, h = state[0]
    assert conv_buf.shape == (3, 32) and h.shape == (32, 8) and h.dtype == torch.float32


# -- cli predict / evaluate against the JAX CLI ----------------------------------

def _write_index_and_lfb(work, rng):
    n = sum(LENGTHS)
    labels = np.zeros((n, 15), np.float32)
    labels[:, 0] = np.concatenate([np.sort(rng.integers(0, 7, L)) for L in LENGTHS])
    labels[:, 1:8] = rng.integers(0, 2, (n, 7))
    labels[:, 8:] = rng.uniform(0, 1, (n, 7))
    idx = os.path.join(work, "index")
    os.makedirs(idx)
    np.save(os.path.join(idx, "test_labels.npy"), labels)
    np.save(os.path.join(idx, "test_num_each.npy"), np.asarray(LENGTHS))
    np.save(os.path.join(idx, "test_video_ids.npy"), np.asarray(IDS, np.int64))
    feats = rng.standard_normal((n, F_DIM)).astype(np.float16).astype(np.float32)
    JaxFeatureStore.create(os.path.join(work, "lfb", "test"), feats, LENGTHS)
    return labels


@pytest.fixture(scope="module")
def work_dirs(tmp_path_factory):
    """Per model kind: a JAX work dir with orbax stores and a port work dir
    with the port's stores, sharing index/ and lfb/ (the two stores would
    collide on step_XXXXXXXX.manifest.json)."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for kind in ("mamba", "mstcn"):
        wj, wt = str(root / f"jax_{kind}"), str(root / f"torch_{kind}")
        labels = _write_index_and_lfb(wj, np.random.default_rng(11))
        os.makedirs(wt)
        for sub in ("index", "lfb"):
            os.symlink(os.path.join(wj, sub), os.path.join(wt, sub))
        jmodel = JaxMamba(MambaConfig()) if kind == "mamba" else JaxMSTCN(MSTCNConfig())
        tparams = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, F_DIM)))["params"]
        rparams = JaxRefiner(RefinerConfig(f_dim=F_DIM)).init(
            jax.random.key(1), jnp.zeros((8, 14)), jnp.zeros((8, F_DIM)))["params"]
        tparams, rparams = jax.tree.map(np.asarray, (tparams, rparams))
        JaxCheckpointStore(os.path.join(wj, "ckpt", "temporal")).save(
            0, tparams, metrics={"val_acc": 0.5})
        JaxCheckpointStore(os.path.join(wj, "ckpt", "refiner")).save(
            0, rparams, metrics={"val_acc": 0.5})
        tsd = (convert.export_mamba_state_dict(tparams, MambaConfig().layers) if kind == "mamba"
               else convert.export_mstcn_state_dict(tparams, 2, 8))
        CheckpointStore(os.path.join(wt, "ckpt", "temporal")).save(
            0, tsd, metrics={"val_acc": 0.5})
        CheckpointStore(os.path.join(wt, "ckpt", "refiner")).save(
            0, convert.export_refiner_state_dict(rparams), metrics={"val_acc": 0.5})
        out[kind] = (wj, wt, jmodel, tparams, rparams, labels)
    return out


@pytest.mark.parametrize("online", [False, True], ids=["offline", "online"])
@pytest.mark.parametrize("kind", ["mamba", "mstcn"])
def test_cli_predict_txts_match_jax(work_dirs, kind, online, capsys):
    wj, wt, jmodel, tparams, rparams, _ = work_dirs[kind]
    flags = ["--split", "test", "--model", kind] + (["--online"] if online else [])
    assert jax_cli.main(["predict", "--work", wj, *flags]) == 0
    jax_metrics = json.loads(capsys.readouterr().out)
    assert cli.main(["predict", "--work", wt, *flags, "--device", "cpu"]) == 0
    port_metrics = json.loads(capsys.readouterr().out)
    for vid in IDS:
        name = f"video{vid}-phase.txt"
        a = open(os.path.join(wj, "output", "Test", name), "rb").read()
        b = open(os.path.join(wt, "output", "Test", name), "rb").read()
        assert a == b, name

    # the metrics JSON key by key: phase metrics from the same argmax are
    # equal; the anticipation MAEs come from the logits, within their bound
    assert sorted(port_metrics) == sorted(jax_metrics)
    for key, want in jax_metrics.items():
        if key in ("inMAE", "pMAE", "eMAE"):
            np.testing.assert_allclose(port_metrics[key], want, rtol=0, atol=ATOL_LOGITS,
                                       err_msg=key)
        else:
            assert port_metrics[key] == want, key

    # the refined logits themselves, so an argmax tie cannot hide a drift
    temporal = cli._temporal_model(kind, "cpu", F_DIM)
    convert_fn = convert.load_mamba_params if kind == "mamba" else convert.load_mstcn_params
    convert_fn(temporal, tparams)
    refiner = RefinementTransformer(port_config.RefinerConfig(f_dim=F_DIM), device="cpu")
    convert.load_refiner_params(refiner, rparams)
    trainer = RefinerTrainer(jmodel, JaxRefiner(RefinerConfig(f_dim=F_DIM)), TrainConfig())
    lfb = np.asarray(FeatureStore.open(os.path.join(wt, "lfb", "test")).video(1),
                     np.float32)
    want = np.asarray(trainer._predict(tparams, rparams, lfb))
    got = predict_video(temporal, refiner, torch.from_numpy(lfb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LOGITS)


def test_cli_evaluate_exit_codes(work_dirs, tmp_path, capsys):
    from surgical_tpu_torch.eval.predictions import video_txt_name, write_phase_txt

    *_, labels = work_dirs["mamba"]
    gt, pred = tmp_path / "gt", tmp_path / "pred"
    starts = np.concatenate([[0], np.cumsum(LENGTHS)[:-1]])
    for vid, s, L in zip(IDS, starts, LENGTHS):
        write_phase_txt(str(gt / video_txt_name(vid)), labels[s:s + L, 0])
        write_phase_txt(str(pred / video_txt_name(vid)), labels[s:s + L, 0])
    args = ["evaluate", "--gt", str(gt), "--pred", str(pred), "--first", "41", "--last", "42"]
    assert cli.main(args) == 0
    assert "Mean Accuracy:  100.00" in capsys.readouterr().out
    os.remove(pred / video_txt_name(42))
    assert cli.main(args) == 1
    assert "MISSING pred txt for video 42" in capsys.readouterr().err


def _relaxation_cases(rng):
    """GT/pred txt pairs that fire every rule of the relaxed evaluation: GT
    runs through all 7 phases in segments longer than the 10-frame
    tolerance; predictions are off by -1/-2 at segment heads and +1/+2 at
    tails (forgiven or not by phase group), wrong in mid-segment, name a
    phase absent from GT, and one is a frame shorter than its GT."""
    gts, preds = [], []
    for v in range(4):
        phases = [p for p in range(7) if not (v == 3 and p == 2)]   # phase 2 absent
        seg = rng.integers(14, 30, len(phases))
        gt = np.repeat(phases, seg)
        pred = gt.copy()
        starts = np.concatenate([[0], np.cumsum(seg)[:-1]])
        for s, L in zip(starts, seg):
            k = rng.integers(1, 6)
            pred[s:s + k] = gt[s] - rng.integers(1, 3)        # head: -1 or -2
            pred[s + L - k:s + L] = gt[s] + rng.integers(1, 3)  # tail: +1 or +2
            pred[s + L // 2] = rng.integers(0, 7)               # mid-segment
        pred = np.clip(pred, 0, 6)
        gts.append(gt)
        preds.append(pred[:-1] if v == 1 else pred)
    return gts, preds


def _noisy_cases(rng):
    """Sorted random GT; predictions with a third of the frames random."""
    gts = [np.sort(rng.integers(0, 7, L)) for L in (60, 83, 41)]
    preds = [np.where(rng.uniform(size=len(g)) < 0.33, rng.integers(0, 7, len(g)), g)
             for g in gts]
    return gts, preds


@pytest.mark.parametrize("cases", [_relaxation_cases, _noisy_cases],
                         ids=["relaxation_rules", "noisy"])
def test_cli_evaluate_matches_jax(tmp_path, capsys, cases):
    """The port's copy of the relaxed evaluation and its table against the
    JAX package's, on imperfect predictions."""
    from surgical_tpu.eval.relaxed import evaluate_videos as jax_evaluate_videos
    from surgical_tpu_torch.eval.predictions import video_txt_name, write_phase_txt
    from surgical_tpu_torch.eval.relaxed import evaluate_videos

    gts, preds = cases(np.random.default_rng(13))
    gt, pred = tmp_path / "gt", tmp_path / "pred"
    for vid, (g, p) in enumerate(zip(gts, preds), start=1):
        write_phase_txt(str(gt / video_txt_name(vid)), g)
        write_phase_txt(str(pred / video_txt_name(vid)), p)
    args = ["evaluate", "--gt", str(gt), "--pred", str(pred),
            "--first", "1", "--last", str(len(gts))]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main(args) == 0
    assert capsys.readouterr().out == want
    assert "Mean Accuracy:  100.00" not in want

    got, ref = evaluate_videos(gts, preds), jax_evaluate_videos(gts, preds)
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(ref, field.name),
                                      err_msg=field.name)


# -- FeatureStore copy --------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_store_opens_the_other_packages_store(tmp_path, writer):
    feats = np.random.default_rng(7).standard_normal((12, 5)).astype(np.float16)
    make, read = ((JaxFeatureStore, FeatureStore) if writer == "jax"
                  else (FeatureStore, JaxFeatureStore))
    make.create(str(tmp_path), feats, [5, 7], meta={"split": "val"})
    store = read.open(str(tmp_path))
    assert store.num_videos == 2 and store.dim == 5 and store.meta == {"split": "val"}
    np.testing.assert_array_equal(store.video(1), feats[5:])


# -- the card by default -----------------------------------------------------------

_NO_DEVICE = {
    "MiTEVP": lambda tmp: MiTEVP(),
    "MultiStageTCN": lambda tmp: MultiStageTCN(),
    "RefinementTransformer": lambda tmp: RefinementTransformer(),
    "CausalMambaModel": lambda tmp: CausalMambaModel(),
    "wire_dequant": lambda tmp: wire_dequant(),
    "CheckpointStore.restore": lambda tmp: _restore_without_device(tmp),
    "cli predict": lambda tmp: cli.main(["predict", "--work", str(tmp)]),
}


def _restore_without_device(tmp):
    model = RefinementTransformer(port_config.RefinerConfig(f_maps=8, f_dim=8), device="cpu")
    store = CheckpointStore(str(tmp))
    store.save(0, model.state_dict())
    store.restore(0, model)


@pytest.mark.parametrize("entry", sorted(_NO_DEVICE))
def test_entry_points_default_to_the_card(entry, tmp_path):
    """With no device named, every entry point asks for the card: here, with
    no card, torch.cuda's own error, never a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
        _NO_DEVICE[entry](tmp_path)
