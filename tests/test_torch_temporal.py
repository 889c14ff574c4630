"""The port's MS-TCN and refinement transformer against the JAX package's in
fp32 under the same weights (max-abs <= 1e-4), and the port's prediction
leg writing phase txts byte-identical to the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from surgical_tpu.core.config import MSTCNConfig, RefinerConfig, TrainConfig
from surgical_tpu.data.feature_store import FeatureStore
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.models.transsv import causal_windows as jax_causal_windows
from surgical_tpu.train.refiner import RefinerTrainer
from surgical_tpu.train.refiner import predict_and_write as jax_predict_and_write
from surgical_tpu.train.temporal import VideoDataset as JaxVideoDataset
from surgical_tpu_torch.models.convert import load_mstcn_params, load_refiner_params
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer, causal_windows
from surgical_tpu_torch.train.refiner import predict_and_write
from surgical_tpu_torch.train.temporal import VideoDataset

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

F_DIM = 32
MSTCN = MSTCNConfig(stages=2, layers=4, f_maps=16, f_dim=F_DIM)
REFINER = RefinerConfig(f_maps=16, f_dim=F_DIM, len_q=6)
ATOL = 1e-4


def _models():
    tparams = JaxMSTCN(MSTCN).init(jax.random.key(0), jnp.zeros((1, 8, F_DIM)))["params"]
    rparams = JaxRefiner(REFINER).init(jax.random.key(1), jnp.zeros((8, 14)),
                                       jnp.zeros((8, F_DIM)))["params"]
    tparams, rparams = jax.tree.map(np.asarray, (tparams, rparams))
    temporal = MultiStageTCN(MSTCN, device="cpu")
    refiner = RefinementTransformer(REFINER, device="cpu")
    load_mstcn_params(temporal, tparams)
    load_refiner_params(refiner, rparams)
    return tparams, rparams, temporal, refiner


def test_causal_windows_match():
    x = np.random.default_rng(0).standard_normal((9, 5)).astype(np.float32)
    np.testing.assert_array_equal(causal_windows(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jax_causal_windows(jnp.asarray(x), 4)))


def test_mstcn_and_refiner_match_jax():
    tparams, rparams, temporal, refiner = _models()
    x = np.random.default_rng(1).standard_normal((2, 50, F_DIM)).astype(np.float32)
    want = np.asarray(JaxMSTCN(MSTCN).apply({"params": tparams}, x))
    with torch.no_grad():
        got = temporal(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 50, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    g = np.array(want[-1, 0])
    want_r = np.asarray(JaxRefiner(REFINER).apply({"params": rparams}, g, x[0]))
    with torch.no_grad():
        got_r = refiner(torch.from_numpy(g), torch.from_numpy(x[0].copy())).numpy()
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=ATOL)


def _dataset(tmp_path, cls):
    rng = np.random.default_rng(2)
    lengths = [40, 57, 33]
    n = sum(lengths)
    store = FeatureStore.create(str(tmp_path / "lfb"),
                                rng.standard_normal((n, F_DIM)).astype(np.float32), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return cls(store, rng.integers(0, 7, n), rng.uniform(0, 1, (n, 7)),
               np.asarray(lengths), starts)


def test_predict_and_write_byte_identical(tmp_path):
    tparams, rparams, temporal, refiner = _models()
    ids = [41, 42, 43]
    trainer = RefinerTrainer(JaxMSTCN(MSTCN), JaxRefiner(REFINER), TrainConfig())
    jm, jpreds, _ = jax_predict_and_write(trainer, tparams, rparams,
                                          _dataset(tmp_path / "j", JaxVideoDataset),
                                          str(tmp_path / "jax"), ids)
    tm, tpreds, _ = predict_and_write(temporal, refiner, _dataset(tmp_path / "t", VideoDataset),
                                      str(tmp_path / "torch"), ids)
    for vid in ids:
        name = f"video{vid}-phase.txt"
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert a == b, name
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert tm["acc_frame"] == jm["acc_frame"]
