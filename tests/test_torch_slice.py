"""The port's main path end to end on the CPU at a tiny size: wire-format
batches -> make_raw_feature_fn -> extract_to_store -> MS-TCN + refiner ->
video<NN>-phase.txt -> relaxed evaluation, held against the JAX package's
wire dequant + fused_forward on the same batches. Plus the port's import
boundary and its no-fallback kernel loader.

Stated bound for the extracted features: correlation > 0.999 against the JAX
path (both bf16, f16 wire; measured 0.999985 here).
"""

import ast
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import MSTCNConfig, RefinerConfig
from surgical_tpu.eval.predictions import read_phase_txt, video_txt_name
from surgical_tpu.eval.relaxed import evaluate_videos
from surgical_tpu.train.extract import wire_dequant as jax_wire_dequant
from surgical_tpu_torch.kernels import _build
from surgical_tpu_torch.models.convert import load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.train.extract import extract_to_store, make_raw_feature_fn, wire_dequant
from surgical_tpu_torch.train.refiner import predict_and_write
from surgical_tpu_torch.train.temporal import VideoDataset
from test_torch_mit_fused import CFG, HEAD, jax_fused_interpret, seeded_evp

PORT = Path(__file__).resolve().parents[1] / "surgical_tpu_torch"
LENGTHS = [6, 10]
BATCH = 8


def _wire_batches(seed=0):
    rng = np.random.default_rng(seed)
    n, S = sum(LENGTHS), CFG.img_size
    img = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (n, S, S, 1), dtype=np.uint8)
    flow = rng.standard_normal((n, S, S, 2)).astype(np.float16)
    return [(img[i:i + BATCH], seg[i:i + BATCH], flow[i:i + BATCH])
            for i in range(0, n, BATCH)]


def test_wire_dequant_matches_jax():
    img, seg, _ = _wire_batches()[0]
    want_i, want_s = jax_wire_dequant()(jnp.asarray(img), jnp.asarray(seg))
    got_i, got_s = wire_dequant("cpu")(torch.from_numpy(img), torch.from_numpy(seg))
    np.testing.assert_array_equal(got_i.float().numpy(), np.asarray(want_i, np.float32))
    np.testing.assert_array_equal(got_s.float().numpy(), np.asarray(want_s, np.float32))


def test_slice_end_to_end(tmp_path):
    variables, *_ = seeded_evp(CFG, HEAD, 1)
    model = MiTEVP(CFG, HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    batches = _wire_batches()

    store, stats = extract_to_store(make_raw_feature_fn(model), iter(batches), LENGTHS,
                                    feature_dim=HEAD.embedding_dim, batch_size=BATCH,
                                    directory=str(tmp_path / "lfb"), meta={"split": "test"})
    assert stats["frames"] == sum(LENGTHS)
    assert store.features.shape == (sum(LENGTHS), HEAD.embedding_dim)
    assert np.isfinite(store.features).all()

    dequant = jax_wire_dequant()
    want = []
    for img, seg, flow in batches:
        i, s = dequant(jnp.asarray(img), jnp.asarray(seg))
        f = jax_fused_interpret(variables, i, s, jnp.asarray(flow, jnp.bfloat16))
        want.append(np.asarray(f.astype(jnp.float16), np.float32))
    want = np.concatenate(want)
    corr = np.corrcoef(np.asarray(store.features).ravel(), want.ravel())[0, 1]
    assert corr > 0.999, corr

    rng = np.random.default_rng(1)
    n = sum(LENGTHS)
    labels = np.sort(rng.integers(0, 7, n))
    starts = np.concatenate([[0], np.cumsum(LENGTHS)[:-1]])
    ds = VideoDataset(store, labels, rng.uniform(0, 1, (n, 7)), np.asarray(LENGTHS), starts)
    temporal = MultiStageTCN(MSTCNConfig(f_maps=16, f_dim=HEAD.embedding_dim),
                             device="cpu")
    refiner = RefinementTransformer(RefinerConfig(f_maps=16, f_dim=HEAD.embedding_dim),
                                    device="cpu")
    ids = [41, 42]
    metrics, preds, _ = predict_and_write(temporal, refiner, ds, str(tmp_path / "out"), ids)
    got = [read_phase_txt(os.path.join(tmp_path, "out", video_txt_name(v))) for v in ids]
    for p, g, L in zip(preds, got, LENGTHS):
        assert len(g) == L
        np.testing.assert_array_equal(g, p)
    gts = [labels[s:s + L] for s, L in zip(starts, LENGTHS)]
    res = evaluate_videos(gts, got)
    assert 0.0 <= res.mean_acc <= 100.0
    assert 0.0 <= metrics["acc_frame"] <= 1.0


def test_port_never_imports_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package
    (the root name only: ``surgical_tpu_torch`` is the port itself)."""
    banned = {"jax", "flax", "optax", "orbax", "surgical_tpu"}
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert not offenders, offenders


def test_kernel_loader_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc and no built library: loading raises, nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
