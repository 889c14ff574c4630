"""The port's bf16 serving forward (CPU, plain kernel versions) against the
JAX package's fused_forward (Pallas kernels in interpret mode) under the same
weights, at the tiny config of test_mit_fused.py with B=8, so that JAX routes
stage 4 through fused_mit_stage as the port does.

Stated bound: correlation > 0.999 and median relative error < 2e-2 over the
pooled features (measured on this config: correlation 0.999975, median
relative error 4.4e-3, max abs error 7.8e-3 on features of mean |f| 0.27).
Both sides compute in bf16; they round at the same places but sum in other
orders, and the plain-XLA parts (convolutions, einsums, bilinear resize)
round once more or once less here and there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.models.mit_evp import MiTEVP as JaxMiTEVP
from surgical_tpu_torch.models.convert import load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mit_fused import fused_forward, kernel_weights

CFG = BackboneConfig(variant="tiny", embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 4, 8),
                     depths=(1, 1, 2, 1), sr_ratios=(8, 4, 2, 1), qkv_bias=True,
                     drop_path_rate=0.0, img_size=64)
HEAD = HeadConfig(embedding_dim=64, hidden=32)
B = 8


def jax_fused_interpret(variables, img, seg, flow, return_features=True):
    """JAX fused_forward with its Pallas kernels wrapped into interpret mode
    (the module-attribute wrap of tests/test_mit_fused.py)."""
    import surgical_tpu.kernels.mit_block as mb
    import surgical_tpu.models.mit_fused as mf

    def wrap(orig):
        def interp(*args, **kw):
            kw["interpret"] = True
            return orig(*args, **kw)
        return interp

    saved = {n: getattr(mb, n)
             for n in ("fused_mit_block", "fused_mit_block_hb", "fused_mit_stage")}
    try:
        for n, orig in saved.items():
            setattr(mb, n, wrap(orig))
            setattr(mf, n, wrap(orig))
        return mf.fused_forward(variables["params"], variables["batch_stats"], img, seg, flow,
                                CFG, HEAD, return_features=return_features, bt=1)
    finally:
        for n, orig in saved.items():
            setattr(mb, n, orig)
            setattr(mf, n, orig)


def seeded_evp(cfg, head, batch, seed=0):
    """JAX MiT-EVP variables with non-trivial BatchNorm statistics, and
    seeded numpy inputs."""
    rng = np.random.default_rng(seed)
    size = cfg.img_size
    img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    seg = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    flow = rng.standard_normal((batch, size, size, 2)).astype(np.float32)
    variables = JaxMiTEVP(cfg, head).init(jax.random.key(seed), img[:1], seg[:1], flow[:1])
    variables = jax.tree.map(np.asarray, variables)
    stats = variables["batch_stats"]
    for group in stats.values():
        for bn in group.values():
            bn["mean"] = 0.1 * rng.standard_normal(bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return variables, img, seg, flow


@pytest.fixture(scope="module")
def setup():
    variables, img, seg, flow = seeded_evp(CFG, HEAD, B)
    model = MiTEVP(CFG, HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    return variables, model, img, seg, flow


def test_fused_forward_matches_jax(setup):
    variables, model, img, seg, flow = setup
    want = np.asarray(jax_fused_interpret(variables, img, seg, flow), np.float32)
    got = fused_forward(model, torch.from_numpy(img), torch.from_numpy(seg),
                        torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (B, HEAD.embedding_dim)
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    assert corr > 0.999, corr
    assert np.median(rel) < 2e-2, np.median(rel)


def test_logits_match_jax(setup):
    """return_features=False: the phase / anticipation MLP heads."""
    variables, model, img, seg, flow = setup
    want = jax_fused_interpret(variables, img, seg, flow, return_features=False)
    got = model(torch.from_numpy(img), torch.from_numpy(seg), torch.from_numpy(flow),
                return_features=False)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape == (B, HEAD.num_phases)
        assert np.corrcoef(g.float().numpy().ravel(), w.ravel())[0, 1] > 0.999


def test_trainer_evaluate_runs_the_serving_graph_like_jax(setup):
    """BackboneTrainer.evaluate runs the serving graph: its logits are held
    to JAX's fused_forward on the same wire batch, dequantized (bf16) and
    centre-cropped as the JAX trainer's eval step does, not to the flax graph
    that step applies (a known difference, ROADMAP Queue 3); its metrics are
    the JAX package's metric functions of those logits."""
    from surgical_tpu.data import transforms as jtf
    from surgical_tpu.eval import metrics as jmetrics
    from surgical_tpu_torch.core.config import TrainConfig
    from surgical_tpu_torch.data.transforms import AugConfig
    from surgical_tpu_torch.train.backbone import BackboneTrainer

    variables, model, *_ = setup
    rng = np.random.default_rng(3)
    r, crop = CFG.img_size + 8, CFG.img_size
    img = rng.integers(0, 256, (B, r, r, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (B, r, r, 1), dtype=np.uint8)
    flow = rng.standard_normal((B, r, r, 2)).astype(np.float16)
    labels = rng.integers(0, HEAD.num_phases, B).astype(np.int32)
    ant = rng.uniform(0, 1, (B, HEAD.num_phases)).astype(np.float32)

    bf = jnp.bfloat16
    jimg = jnp.asarray(img).astype(bf) / jnp.asarray(255.0, bf)
    jseg = jnp.broadcast_to(jnp.asarray(seg).astype(bf) / jnp.asarray(255.0, bf), jimg.shape)
    want = jax_fused_interpret(variables, *jtf.eval_preprocess_clip(
        jimg, jseg, jnp.asarray(flow).astype(bf), jtf.AugConfig(resize=r, crop=crop)),
        return_features=False)

    trainer = BackboneTrainer(model, TrainConfig(), aug_cfg=AugConfig(resize=r, crop=crop),
                              use_fused=True)
    got = trainer.eval_step(img, seg, flow)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape == (B, HEAD.num_phases)
        assert np.corrcoef(g.numpy().ravel(), w.ravel())[0, 1] > 0.999

    metrics = trainer.evaluate([(img, seg, flow, labels, ant)], num_each=[B // 2, B // 2])
    pred = got[0].argmax(-1).numpy()
    triad = jmetrics.MAETriad(horizon=TrainConfig().horizon)
    triad.update(got[1].numpy(), ant)
    prj = jmetrics.precision_recall_jaccard(labels, pred)
    ref = {"acc": jmetrics.frame_accuracy(labels, pred), **triad.result(),
           **{k: v for k, v in prj.items() if np.isscalar(v)},
           "acc_video": float(np.mean([jmetrics.frame_accuracy(labels[i:i + B // 2],
                                                               pred[i:i + B // 2])
                                       for i in (0, B // 2)]))}
    assert metrics.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-12, err_msg=k)


def test_kernel_weights_cached_until_parameters_change():
    """Built once per parameter state: the same dicts on a second call, new
    ones holding the new values after load_state_dict."""
    model = MiTEVP(CFG, HEAD, seed=0, device="cpu")
    first = kernel_weights(model)
    assert kernel_weights(model) is first
    other = MiTEVP(CFG, HEAD, seed=1, device="cpu")
    model.load_state_dict(other.state_dict())
    second = kernel_weights(model)
    assert second is not first
    want = other.block3[1].attn.q.weight.t().to(torch.bfloat16)
    torch.testing.assert_close(second[3][1]["wq"], want, rtol=0, atol=0)
    want4 = other.block4[0].mlp.fc1.weight.t().to(torch.bfloat16)
    torch.testing.assert_close(second[4]["w1"][0], want4, rtol=0, atol=0)
