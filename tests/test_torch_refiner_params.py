"""The port's refiner with the JAX package's parameter set: each attention
block's and FFN's LayerNorm with scale and bias, and the FFN's biases.

Three Adam steps of JAX's ``RefinerTrainer`` and of the port's from one
initial state agree on every parameter, the LayerNorm scales and FFN biases
among them, which move; a refiner trained by JAX loads into the port
(``load_trained_refiner_params``) and gives JAX's outputs offline and
streamed, where the reference-layout route raises; a reference-layout
``.pth`` (no LayerNorm or FFN-bias keys) loads with identity LayerNorms and
zero biases filled and logged, strict about every other key.

Tiny sizes (the refiner f_maps 8, f_dim 16, len_q 6 over test_torch_
temporal_train.py's MS-TCN; videos of 64 frames, their bucket, so both
sides run the same length). Stated bounds: every parameter and the losses
1e-5 max abs after each step (fp32; JAX at "highest" matmul precision, as
the one-step test of test_torch_temporal_train.py); outputs 1e-5 max abs.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import OptimConfig, RefinerConfig, TrainConfig
from surgical_tpu.models.convert import export_refiner_state_dict as jax_export_refiner
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.train.refiner import RefinerTrainer as JaxRefinerTrainer
from surgical_tpu_torch.core import config as port_config
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving.online import OnlineRefiner
from surgical_tpu_torch.train.refiner import RefinerTrainer
from test_torch_temporal_train import (BUCKETS, F_DIM, REFINER, _ds, _jax_model, _port_cfg,
                                       _port_model)

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

EXACT = 1e-5
STEPS, LENGTH = 3, 64
LN_AND_BIAS = ("layernorm.weight", "layernorm.bias", "fc.0.bias", "fc.2.bias")


def _assert_params_close(model, jax_params, atol):
    want = convert.refiner_state_dict(jax.tree.map(np.asarray, jax_params),
                                      model.cfg.n_layers)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def trained():
    """JAX's and the port's refiner trainers over one frozen MS-TCN, three
    steps on three 64-frame videos from the JAX init: (JAX params after each
    step, the port's state dicts after each step, both sides' losses, the
    initial params)."""
    cfg = TrainConfig(bucket_sizes=BUCKETS,
                      optim=OptimConfig(name="adam", lr=5e-3, weight_decay=0.0))
    jtemporal = _jax_model("mstcn")
    tparams = jax.tree.map(np.asarray, jtemporal.init(jax.random.key(0),
                                                      jnp.zeros((1, 8, F_DIM)))["params"])
    jr = JaxRefinerTrainer(jtemporal, JaxRefiner(RefinerConfig(**REFINER)), cfg)
    rparams, ropt = jr.init(jax.random.key(1), tparams, F_DIM)
    init = jax.tree.map(np.asarray, rparams)
    refiner = RefinementTransformer(port_config.RefinerConfig(**REFINER), device="cpu")
    convert.load_trained_refiner_params(refiner, init)
    trainer = RefinerTrainer(_port_model("mstcn", tparams), refiner, _port_cfg(cfg))
    opt = trainer.init()
    ds = _ds([LENGTH] * STEPS, seed=11)
    jax_params, port_states, losses = [], [], []
    for i in range(STEPS):
        f, l, a = ds.video_arrays(i)
        rparams, ropt, *jout = jr._train_step(tparams, rparams, ropt, f, l, a,
                                              np.ones(LENGTH, bool))
        pout = trainer.train_step(opt, torch.from_numpy(f), torch.from_numpy(l).long(),
                                  torch.from_numpy(a))
        jax_params.append(jax.tree.map(np.asarray, rparams))
        port_states.append({k: v.clone() for k, v in refiner.state_dict().items()})
        losses.append(([float(v) for v in pout[:3]], [float(v) for v in jout[:3]]))
    return jax_params, port_states, losses, init


def test_three_refiner_steps_match_jax_on_every_parameter(trained):
    jax_params, port_states, losses, _ = trained
    model = RefinementTransformer(port_config.RefinerConfig(**REFINER), device="cpu")
    for step, (jp, sd, (got, want)) in enumerate(zip(jax_params, port_states, losses)):
        np.testing.assert_allclose(got, want, rtol=0, atol=EXACT, err_msg=f"step {step}")
        model.load_state_dict(sd)
        _assert_params_close(model, jp, EXACT)


def test_layernorms_and_ffn_biases_move_in_both(trained):
    """JAX's optimizer moves the LayerNorm affines and FFN biases from
    identity and zero; the port's now holds them and moves them alike."""
    jax_params, port_states, _, init = trained
    start = convert.refiner_state_dict(init)
    moved = [k for k in start if k.endswith(LN_AND_BIAS)]
    assert len(moved) == 14  # 4 attention LayerNorms, 2 FFN LayerNorms, 2 x 2 FFN biases
    want = convert.refiner_state_dict(jax_params[-1])
    for k in moved:
        assert np.abs(want[k] - start[k]).max() > 1e-4, k
        assert np.abs(port_states[-1][k].numpy() - start[k]).max() > 1e-4, k


def test_jax_trained_refiner_loads_and_gives_jax_outputs(trained):
    """A refiner JAX has trained (non-identity LayerNorms, nonzero FFN
    biases): the reference-layout route refuses it, as it did for every
    trained refiner; ``load_trained_refiner_params`` carries it, and the
    port gives JAX's refined logits offline and through the streaming step."""
    params = trained[0][-1]
    rng = np.random.default_rng(2)
    T = 23
    g = rng.standard_normal((T, 14)).astype(np.float32)
    lfb = rng.standard_normal((T, F_DIM)).astype(np.float32)
    want = np.asarray(JaxRefiner(RefinerConfig(**REFINER)).apply({"params": params}, g, lfb))
    model = RefinementTransformer(port_config.RefinerConfig(**REFINER), device="cpu")
    with pytest.raises(AssertionError, match="non-identity LayerNorm"):
        convert.load_refiner_params(model, params)
    convert.load_trained_refiner_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(g), torch.from_numpy(lfb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    streamed = OnlineRefiner(model).run(torch.from_numpy(g), torch.from_numpy(lfb)).numpy()
    np.testing.assert_allclose(streamed, want, rtol=0, atol=EXACT)


def test_reference_layout_pth_loads_with_identity_filled(tmp_path, caplog):
    """A reference ``.pth`` (JAX's exporter at the init: no LayerNorm, no FFN
    bias) loads strictly with identity LayerNorms and zero biases filled and
    named in the log, and gives JAX's outputs; a key of neither layout and a
    missing weight still raise."""
    init = jax.tree.map(np.asarray, JaxRefiner(RefinerConfig(**REFINER)).init(
        jax.random.key(3), jnp.zeros((8, 14)), jnp.zeros((8, F_DIM)))["params"])
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jax_export_refiner(init).items()}
    assert not any(k.endswith(LN_AND_BIAS) for k in sd)
    path = tmp_path / "refiner.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    model = RefinementTransformer(port_config.RefinerConfig(**REFINER), seed=9, device="cpu")
    with caplog.at_level(logging.INFO, logger="surgical_tpu_torch.models.transsv"):
        model.load_state_dict(convert.load_torch_pth(str(path)), strict=True)
    filled = [k for k in model.state_dict() if k.endswith(LN_AND_BIAS)]
    assert len(filled) == 14 and all(k in caplog.text for k in filled)
    for k in filled:
        want = 1.0 if k.endswith("layernorm.weight") else 0.0
        assert torch.equal(model.state_dict()[k], torch.full_like(model.state_dict()[k], want))
    rng = np.random.default_rng(4)
    g = rng.standard_normal((17, 14)).astype(np.float32)
    lfb = rng.standard_normal((17, F_DIM)).astype(np.float32)
    want = np.asarray(JaxRefiner(RefinerConfig(**REFINER)).apply({"params": init}, g, lfb))
    with torch.no_grad():
        got = model(torch.from_numpy(g), torch.from_numpy(lfb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict({**sd, "transformer.extra.weight": sd["fc.weight"]}, strict=True)
    missing = {k: v for k, v in sd.items() if not k.endswith("dec_enc_attn.W_K.weight")}
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(missing, strict=True)
