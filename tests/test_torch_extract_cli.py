"""The port's LFB-extraction CLI on the CPU: ``prepare-data``,
``cache-frames``, ``extract-features`` and ``reference-parity``, with their
numpy-only data modules and checkpoint-dims helpers, held to the JAX
package on its synthetic Cholec80-layout corpus and its reference-format
``.pth`` oracles (``tests/test_reference_parity.py``).

Stated bounds: the index, the caches, the data modules and the dims helpers
are equal; the stores equal the port's own ``extract_to_store`` exactly
(the same code on the same frames); the features hold correlation > 0.999
against JAX's fused graph (interpret mode) on the same dequantized batch,
the bound of ``tests/test_torch_slice.py`` (both bf16 with an f16 wire);
``reference_parity.json`` agrees with JAX's to 1e-6 and the phase txts are
byte-identical, both running on the same stores.
"""

import filecmp
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu import cli as jax_cli
from surgical_tpu.cli import _write_synthetic_corpus
from surgical_tpu.core.config import BackboneConfig as JaxBackboneConfig
from surgical_tpu.core.config import HeadConfig as JaxHeadConfig
from surgical_tpu.data import anticipation as janticipation
from surgical_tpu.data import cholec80 as jcholec80
from surgical_tpu.data.datasets import ClipDataset as JaxClipDataset
from surgical_tpu.data.datasets import FrameCache as JaxFrameCache
from surgical_tpu.data.feature_store import FeatureStore as JaxFeatureStore
from surgical_tpu.models import convert as jconvert
from surgical_tpu.train.extract import wire_dequant as jax_wire_dequant
from surgical_tpu_torch import cli
from surgical_tpu_torch.core.checkpoint import CheckpointStore
from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.data import anticipation, cholec80
from surgical_tpu_torch.data.datasets import ClipDataset, prefetch_batches
from surgical_tpu_torch.data.feature_store import FeatureStore
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.train.extract import extract_to_store, make_raw_feature_fn
from test_reference_parity import _save_checkpoints
from test_torch_packed2 import jax_fused_interpret_cfg

import test_convert as tc
import test_convert_evp as tce
import test_convert_refiner as tcr

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

NUM_VIDEOS, FRAMES, BATCH = 4, 8, 8
DIMS = ["--variant", "tiny", "--depths", ",".join(map(str, tce.DEPTHS)),
        "--head-dim", str(tce.E), "--head-hidden", str(tce.HID)]
SCHEMES = ("stage1", "stage2", "m2cai", "m2cai_all", "smoke")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    td = tmp_path_factory.mktemp("extract_cli")
    root = str(td / "cholec80")
    _write_synthetic_corpus(root, num_videos=NUM_VIDEOS, frames=FRAMES)
    return {"td": td, "root": root, **_save_checkpoints(str(td))}


def _port_model(evp_path):
    cfg = BackboneConfig.preset("tiny", depths=tce.DEPTHS)
    model = MiTEVP(cfg, HeadConfig(embedding_dim=tce.E, hidden=tce.HID), device="cpu")
    model.load_state_dict(convert.load_torch_pth(evp_path), strict=True)
    return model


def _prepare(work, root, prog=cli):
    assert prog.main(["prepare-data", "--root", root, "--out", work, "--num-videos",
                      str(NUM_VIDEOS), "--scheme", "smoke"]) == 0


def _split_dataset(work, split):
    idx = os.path.join(work, "index")
    with open(os.path.join(idx, f"{split}_paths.json")) as f:
        paths = json.load(f)
    return ClipDataset(paths, np.load(os.path.join(idx, f"{split}_labels.npy")))


@pytest.fixture(scope="module")
def extracted(corpus):
    """One port extraction with --pretrained-evp and --reference-pickles."""
    work = str(corpus["td"] / "work_extract")
    _prepare(work, corpus["root"])
    assert cli.main(["extract-features", "--work", work, *DIMS, "--device", "cpu",
                     "--pretrained-evp", corpus["evp"], "--reference-pickles",
                     "--batch-size", str(BATCH)]) == 0
    return work


def _features(work, split):
    return np.asarray(FeatureStore.open(os.path.join(work, "lfb", split)).features)


# -- data modules ------------------------------------------------------------------

def _assert_split_equal(got, want):
    assert got.paths == want.paths and got.num_each == want.num_each
    assert got.video_ids == want.video_ids
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_index_and_splits_match_jax(corpus, scheme):
    got = cholec80.index_dataset(corpus["root"], num_videos=NUM_VIDEOS)
    want = jcholec80.index_dataset(corpus["root"], num_videos=NUM_VIDEOS)
    for g, w in zip(got, want, strict=True):
        assert g.video_id == w.video_id and g.img_paths == w.img_paths
        np.testing.assert_array_equal(g.labels, w.labels)
    for g, w in zip(cholec80.make_splits(got, scheme), jcholec80.make_splits(want, scheme),
                    strict=True):
        _assert_split_equal(g, w)


def test_m2cai_layout_and_reference_pickle_match_jax(tmp_path):
    root = str(tmp_path / "m2cai")
    os.makedirs(os.path.join(root, "phase_annotations"))
    rng = np.random.default_rng(0)
    for v in range(1, 4):
        phases = np.sort(rng.integers(0, 8, 200))
        with open(os.path.join(root, "phase_annotations", f"video{v:02d}-phase.txt"), "w") as f:
            f.write("Frame\tPhase\n")
            f.writelines(f"{i}\t{cholec80.M2CAI_PHASE_NAMES[p]}\n" for i, p in enumerate(phases))
    got = cholec80.index_dataset(root, num_videos=3, dataset="m2cai16")
    want = jcholec80.index_dataset(root, num_videos=3, dataset="m2cai16")
    assert got[0].labels.shape == (8, 9)  # [phase, 8 x anticipation]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.labels, w.labels)
    splits = cholec80.make_splits(got, "smoke")
    # the port writes, JAX reads; JAX writes, the port reads
    cholec80.to_reference_pickle(*splits, str(tmp_path / "port.pkl"))
    jcholec80.to_reference_pickle(*jcholec80.make_splits(want, "smoke"),
                                  str(tmp_path / "jax.pkl"))
    for g, w in zip(jcholec80.from_reference_pickle(str(tmp_path / "port.pkl")),
                    cholec80.from_reference_pickle(str(tmp_path / "jax.pkl")), strict=True):
        _assert_split_equal(g, w)
    assert filecmp.cmp(tmp_path / "port.pkl", tmp_path / "jax.pkl", shallow=False)


@pytest.mark.parametrize("horizon", [5.0, 0.1])
def test_anticipation_gt_matches_jax(horizon):
    rng = np.random.default_rng(1)
    phases = np.repeat(rng.integers(0, 7, 12), rng.integers(1, 400, 12))
    got = anticipation.anticipation_gt(anticipation.phases_to_one_hot(phases), horizon)
    want = janticipation.anticipation_gt(janticipation.phases_to_one_hot(phases), horizon)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["mstcn", "mstcn_wide", "refiner"])
def test_infer_dims_match_jax(kind):
    torch.manual_seed(0)
    mod = {"mstcn": lambda: tc.TorchMSTCN(stages=2, layers=3, f_maps=8, dim=16, out=14),
           "mstcn_wide": lambda: tc.TorchMSTCN(stages=3, layers=8, f_maps=32, dim=2048, out=14),
           "refiner": tcr._Oracle}[kind]()
    sd = {k: v.detach().numpy() for k, v in mod.state_dict().items()}
    fn = "infer_refiner_dims" if kind == "refiner" else "infer_mstcn_dims"
    assert getattr(convert, fn)(mod.state_dict()) == getattr(jconvert, fn)(sd)


# -- prepare-data, cache-frames ------------------------------------------------------

def test_prepare_data_matches_jax(corpus, tmp_path):
    for prog, name in ((cli, "port"), (jax_cli, "jax")):
        assert prog.main(["prepare-data", "--root", corpus["root"], "--out",
                          str(tmp_path / name), "--num-videos", str(NUM_VIDEOS),
                          "--scheme", "smoke", "--reference-pickle",
                          str(tmp_path / name / "ref.pkl")]) == 0
    idx = lambda name: tmp_path / name / "index"
    files = sorted(os.listdir(idx("jax")))
    assert files == sorted(os.listdir(idx("port"))) and len(files) == 12
    for f in files:
        if f.endswith(".npy"):
            a, b = np.load(idx("port") / f), np.load(idx("jax") / f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert filecmp.cmp(idx("port") / f, idx("jax") / f, shallow=False), f
    assert filecmp.cmp(tmp_path / "port" / "ref.pkl", tmp_path / "jax" / "ref.pkl",
                       shallow=False)


def test_cache_frames_matches_jax(corpus, tmp_path, monkeypatch):
    """The port's cache on its PIL route (the native decoder made
    unavailable, as on a host without g++ or libjpeg) against the JAX
    package's ``FrameCache.build`` over its PIL-decoded ClipDataset. Both
    packages' default native route is held in tests/test_torch_native.py."""
    from surgical_tpu_torch import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", "made unavailable by the test")
    work = str(tmp_path / "work")
    _prepare(work, corpus["root"])
    assert cli.main(["cache-frames", "--work", work, "--splits", "val,test",
                     "--batch-size", "4"]) == 0
    for split in ("val", "test"):
        ds = _split_dataset(work, split)
        want = JaxFrameCache.build(JaxClipDataset(ds.paths, ds.labels, use_native=False),
                                   str(tmp_path / "jax" / split), batch_size=4)
        got_dir = os.path.join(work, "frame_cache", split)
        for f in ("img.npy", "seg.npy", "flow.npy", "labels.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(got_dir, f)),
                                          np.load(os.path.join(want.directory, f)), err_msg=f)
        with open(os.path.join(got_dir, "manifest.json")) as f:
            assert json.load(f) == want.meta
    assert not os.path.exists(os.path.join(work, "frame_cache", "train"))


# -- extract-features ------------------------------------------------------------------

def test_extract_features_equals_extract_to_store(corpus, extracted, tmp_path):
    model = _port_model(corpus["evp"])
    for split in ("train", "val", "test"):
        ds = _split_dataset(extracted, split)
        lengths = np.load(os.path.join(extracted, "index", f"{split}_num_each.npy"))
        batches = ((i, s, f) for i, s, f, _, _ in prefetch_batches(ds, np.arange(len(ds)), BATCH))
        want, _ = extract_to_store(make_raw_feature_fn(model), batches, lengths.tolist(), tce.E,
                                   BATCH, str(tmp_path / split))
        got = FeatureStore.open(os.path.join(extracted, "lfb", split))
        assert got.meta["split"] == split and got.lengths.tolist() == lengths.tolist()
        np.testing.assert_array_equal(np.asarray(got.features), np.asarray(want.features))
        # JAX's FeatureStore reads the reference pickle
        pkl = os.path.join(extracted, "lfb", f"evp_LFB_{split}.pkl")
        jstore = JaxFeatureStore.from_reference_pickle(pkl, lengths, str(tmp_path / f"j{split}"))
        np.testing.assert_array_equal(np.asarray(jstore.features), np.asarray(got.features))


def test_extract_features_weight_quant_int8(corpus, extracted, tmp_path):
    """``extract-features --weight-quant int8``: the store equals
    ``make_raw_feature_fn(weight_quant="int8")`` on the same frames, and
    lies near the fp store within JAX's gates (tests/test_quant.py)."""
    work = str(tmp_path / "work_int8")
    shutil.copytree(os.path.join(extracted, "index"), os.path.join(work, "index"))
    assert cli.main(["extract-features", "--work", work, *DIMS, "--device", "cpu",
                     "--pretrained-evp", corpus["evp"], "--weight-quant", "int8",
                     "--splits", "val", "--batch-size", str(BATCH)]) == 0
    ds = _split_dataset(work, "val")
    lengths = np.load(os.path.join(work, "index", "val_num_each.npy"))
    batches = ((i, s, f) for i, s, f, _, _ in prefetch_batches(ds, np.arange(len(ds)), BATCH))
    want, _ = extract_to_store(make_raw_feature_fn(_port_model(corpus["evp"]),
                                                   weight_quant="int8"),
                               batches, lengths.tolist(), tce.E, BATCH, str(tmp_path / "want"))
    got, fp = _features(work, "val"), _features(extracted, "val")
    np.testing.assert_array_equal(got, np.asarray(want.features))
    assert not os.path.exists(os.path.join(work, "lfb", "train"))
    rel = np.abs(got - fp) / np.maximum(np.abs(fp), 1e-2)
    assert not np.array_equal(got, fp) and np.median(rel) < 0.2
    assert np.corrcoef(got.ravel(), fp.ravel())[0, 1] > 0.95


def test_extracted_features_match_jax_fused_graph(corpus, extracted):
    """The val split's batch through JAX's wire dequant and fused graph
    (interpret mode) under the JAX import of the same .pth."""
    ds = _split_dataset(extracted, "val")
    img, seg, flow, _, _ = ds.frames(np.arange(len(ds)))
    sd = jconvert.load_torch_pth(corpus["evp"])
    params, stats = jconvert.import_evp_state_dict(sd, tce.DEPTHS)
    i, s = jax_wire_dequant()(jnp.asarray(img), jnp.asarray(seg))
    cfg = JaxBackboneConfig.preset("tiny", depths=tce.DEPTHS)
    want = jax_fused_interpret_cfg({"params": params, "batch_stats": stats}, i, s,
                                   jnp.asarray(flow, jnp.bfloat16), cfg,
                                   JaxHeadConfig(embedding_dim=tce.E, hidden=tce.HID))
    want = want.astype(np.float16).astype(np.float32)
    got = _features(extracted, "val")
    assert got.shape == want.shape == (len(ds), tce.E) and np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.999, corr


def test_extract_from_frame_cache_equals_decode_path(corpus, extracted, tmp_path):
    work = str(tmp_path / "work")
    shutil.copytree(os.path.join(extracted, "index"), os.path.join(work, "index"))
    cache = str(tmp_path / "cache")
    assert cli.main(["cache-frames", "--work", work, "--out", cache]) == 0
    assert cli.main(["extract-features", "--work", work, *DIMS, "--device", "cpu",
                     "--pretrained-evp", corpus["evp"], "--frame-cache", cache,
                     "--batch-size", str(BATCH)]) == 0
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(_features(work, split), _features(extracted, split))

    # a cache without flow under a flow model exits
    assert cli.main(["cache-frames", "--work", work, "--out", str(tmp_path / "noflow"),
                     "--splits", "test", "--no-flow"]) == 0
    with pytest.raises(SystemExit, match="no-flow"):
        cli.main(["extract-features", "--work", work, *DIMS, "--device", "cpu",
                  "--pretrained-evp", corpus["evp"], "--frame-cache", str(tmp_path / "noflow")])


def test_extract_restores_backbone_store_step(corpus, extracted, tmp_path):
    """Without --pretrained-evp the backbone comes from ckpt/backbone: the
    best step by val_acc, or --step."""
    work = str(tmp_path / "work")
    shutil.copytree(os.path.join(extracted, "index"), os.path.join(work, "index"))
    cfg = BackboneConfig.preset("tiny", depths=tce.DEPTHS)
    head = HeadConfig(embedding_dim=tce.E, hidden=tce.HID)
    models = [MiTEVP(cfg, head, seed=s, device="cpu") for s in (1, 2)]
    store = CheckpointStore(os.path.join(work, "ckpt", "backbone"))
    for step, (m, acc) in enumerate(zip(models, (0.9, 0.1))):
        store.save(step, m.state_dict(), metrics={"val_acc": acc})
    ds = _split_dataset(work, "test")
    frames = ds.frames(np.arange(len(ds)))[:3]
    for extra, model in (([], models[0]), (["--step", "1"], models[1])):
        assert cli.main(["extract-features", "--work", work, *DIMS, "--device", "cpu",
                         "--splits", "test", "--batch-size", str(BATCH), *extra]) == 0
        want = make_raw_feature_fn(model)(*frames).float().numpy()
        np.testing.assert_array_equal(_features(work, "test"), want)
    assert not os.path.exists(os.path.join(work, "lfb", "val"))


# -- reference-parity --------------------------------------------------------------------

def test_reference_parity_matches_jax(corpus, tmp_path, capsys):
    work_a, work_b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["reference-parity", "--root", corpus["root"], "--evp", corpus["evp"],
            "--temporal", corpus["temporal"], "--refiner", corpus["refiner"], *DIMS,
            "--num-videos", str(NUM_VIDEOS), "--scheme", "smoke", "--batch-size", str(BATCH),
            "--chain-depth", "1", "--len-q", "6", "--online"]
    assert cli.main([*args, "--work", work_a, "--device", "cpu"]) == 0
    for d in ("index", "lfb"):
        shutil.copytree(os.path.join(work_a, d), os.path.join(work_b, d))
    assert jax_cli.main([*args, "--work", work_b]) == 0

    load = lambda w: json.load(open(os.path.join(w, "reference_parity.json")))
    got, want = load(work_a), load(work_b)
    assert got.keys() == want.keys() and got["online_offline_agreement"] >= 0.999
    for split in ("val", "test"):
        assert got[split].keys() == want[split].keys()
        for k, v in want[split].items():
            assert np.isfinite(got[split][k]), k
            np.testing.assert_allclose(got[split][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["online_offline_agreement"], want["online_offline_agreement"])
    for sub in ("Val", "Test", "TestOnline"):
        a, b = os.path.join(work_a, "output", sub), os.path.join(work_b, "output", sub)
        names = sorted(os.listdir(b))
        assert names and sorted(os.listdir(a)) == names
        for n in names:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), (sub, n)

    # a second run reuses the stores
    stamp = os.path.getmtime(os.path.join(work_a, "lfb", "test", "features.npy"))
    capsys.readouterr()
    assert cli.main([*args, "--work", work_a, "--device", "cpu"]) == 0
    assert "reusing existing LFB stores" in capsys.readouterr().out
    assert os.path.getmtime(os.path.join(work_a, "lfb", "test", "features.npy")) == stamp
    assert load(work_a) == got


@pytest.mark.parametrize("side", [16, 24])
def test_cpu_conv_accumulates_in_fp32(side):
    """The serving graph's convolutions on the CPU: bf16 operands summed in
    fp32 and rounded once. PyTorch's own bf16 CPU convolution gives wrong
    sums for the 8x8 stride-8 SR conv over a 24x24 grid (96-px frames),
    which took the port's CPU features off JAX's at such sizes."""
    from surgical_tpu_torch.models import _ops

    torch.manual_seed(0)
    conv = torch.nn.Conv2d(8, 8, 8, 8)
    x = torch.randn(2, side, side, 8).to(torch.bfloat16)
    w = conv.weight.to(torch.bfloat16).float()
    want = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), w, None, 8)
    want = (want.to(torch.bfloat16).permute(0, 2, 3, 1).float() + conv.bias).to(torch.bfloat16)
    torch.testing.assert_close(_ops.conv(x, conv, 8, 0), want, rtol=0, atol=0)


def test_chip_smoke_cli_phase_on_cpu(tmp_path):
    """chip_smoke.py's extraction-CLI phase, sized down to the tiny variant on
    the CPU: the same verbs and checks as on the card."""
    import chip_smoke

    res = chip_smoke.phase_extract_cli(
        str(tmp_path), cfg=BackboneConfig.preset("tiny"),
        head_cfg=HeadConfig(embedding_dim=32, hidden=16), model_flags=["--variant", "tiny"],
        device="cpu", lengths=(6, 5, 8, 9), batch=4, raft_iters=2)
    assert res["agreement"] == 1.0
    assert {"prepare-data", "precompute-flow", "cache-frames", "extract-features",
            "reference-parity"} <= set(res["seconds"])
