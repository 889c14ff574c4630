"""The port's flax-graph MiT-EVP (``MiTEVP.graph_forward``) against the JAX
package's ``MiTEVP.apply`` on the CPU, with JAX weights built from a seeded
port model through the JAX importer (no flax init), at the tiny dims of
tests/test_prompt_variants.py in fp32 under the conftest's "highest" matmul
precision.

Stated bounds: eval outputs rel L2 <= 1e-5 in fp32 for every prompt input
type, adaptor mode and tuning subset, flow on and off, qkv bias off; one
bf16 case at rel L2 <= 2e-2 (both sides round at the same places; the
erf GELU and the matmuls round once per op on both sides but sum in other
orders). The SRM and FFT prompts and the captured attention probabilities
1e-6 / 1e-5. Train mode with the same DropPath and dropout masks injected
on both sides (flax's through ``flax.linen.intercept_methods``): outputs and
new BatchNorm statistics 1e-5, the trainable gradients (over the JAX
package's ``partition_params``) rel L2 <= 1e-4 per tensor; the biases in front of
the head's train-mode BatchNorm, whose gradient is structurally zero, at
most 1e-5 of the largest gradient on both sides.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.models import mit_evp as jme
from surgical_tpu.models.convert import import_evp_state_dict
from surgical_tpu.train.backbone import combine_params, partition_params
from surgical_tpu_torch.models import mit_evp as pme
from surgical_tpu_torch.models.convert import export_evp_state_dict, load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.train.backbone import freeze_trunk

HEAD = HeadConfig(embedding_dim=32, hidden=16)
B = 2


def tiny(**kw):
    """tests/test_prompt_variants.py's tiny dims, two blocks at stage 1."""
    base = dict(variant="tiny", embed_dims=(8, 16, 24, 32), num_heads=(1, 2, 4, 8),
                depths=(2, 1, 1, 1), sr_ratios=(8, 4, 2, 1), qkv_bias=True,
                drop_path_rate=0.0, with_flow=False, img_size=64)
    return BackboneConfig(**{**base, **kw})


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def jax_variables(cfg, head, seed):
    """JAX (params, batch_stats[, constants]) from a seeded port model through
    the JAX importer, every leaf perturbed (no zero bias, a non-zero bimask
    embedding) and non-trivial BatchNorm statistics. The importer reads a
    missing linear bias as an object array of None (qkv_bias=False); those
    leaves are dropped, as a flax init has none."""
    sd = {k: v.numpy() for k, v in MiTEVP(cfg, head, seed=seed, device="cpu").state_dict().items()}
    params, stats = import_evp_state_dict(sd, cfg.depths)
    params = _drop_none(params)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32), params)
    stats = jax.tree.map(np.asarray, stats)
    for group in stats.values():
        for bn in group.values():
            bn["mean"] = 0.1 * rng.standard_normal(bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if cfg.input_type == "all":
        variables["constants"] = {"prompt_generator": {"prompt": np.zeros(
            (cfg.img_size, cfg.img_size, 3), np.float32)}}
    return variables


def _drop_none(tree):
    if isinstance(tree, dict):
        return {k: _drop_none(v) for k, v in tree.items()
                if not (isinstance(v, np.ndarray) and v.dtype == object)}
    return tree


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.img_size
    img, seg, flow = (rng.standard_normal((B, s, s, c)).astype(np.float32) for c in (3, 3, 2))
    return img, seg, flow if cfg.with_flow else None


def port_model(cfg, head, variables):
    model = MiTEVP(cfg, head, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    return model


def _t(a):
    return None if a is None else torch.from_numpy(a)


VARIANTS = {
    "gaussian_flow": dict(with_flow=True),
    "gaussian": {},
    "srm": dict(input_type="srm"),
    "fft": dict(input_type="fft"),
    "all": dict(input_type="all"),
    "bimask": dict(input_type="bimask"),
    "raw": dict(input_type="raw"),
    "fully_shared": dict(adaptor="fully_shared"),
    "fully_unshared": dict(adaptor="fully_unshared", with_flow=True),
    # the handcrafted cascade skips untuned stages (stage 3's generator would
    # see the full-size segmap and miss the tokens' grid in JAX as here), so
    # a later-stage subset runs with the embedding prompts alone
    "stages_34": dict(tuning_stage="34", handcrafted_tune=False),
    "stages_12": dict(tuning_stage="12"),
    "no_handcrafted": dict(handcrafted_tune=False),
    "no_embedding": dict(embedding_tune=False),
    "no_qkv_bias": dict(qkv_bias=False, with_flow=True),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_eval_forward_matches_flax(name):
    cfg = tiny(**VARIANTS[name])
    variables = jax_variables(cfg, HEAD, 1)
    img, seg, flow = inputs(cfg)
    want = jme.MiTEVP(cfg, HEAD).apply(variables, img, seg, flow)
    got = port_model(cfg, HEAD, variables).graph_forward(_t(img), _t(seg), _t(flow))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape == (B, HEAD.num_phases)
        assert rel_l2(g.detach().numpy(), w) <= 1e-5, (name, rel_l2(g.detach().numpy(), w))


def test_eval_features_and_bf16_match_flax():
    """return_features=True in fp32 (1e-5), and the default prompts with
    flow at compute dtype bf16 (rel L2 <= 2e-2)."""
    cfg = tiny(with_flow=True)
    variables = jax_variables(cfg, HEAD, 2)
    img, seg, flow = inputs(cfg, 2)
    model = port_model(cfg, HEAD, variables)
    want = jme.MiTEVP(cfg, HEAD).apply(variables, img, seg, flow, return_features=True)
    got = model.graph_forward(_t(img), _t(seg), _t(flow), return_features=True)
    assert got.shape == want.shape == (B, HEAD.embedding_dim)
    assert rel_l2(got.detach().numpy(), want) <= 1e-5
    want = jax.jit(jme.MiTEVP(cfg, HEAD, compute_dtype=jnp.bfloat16).apply)(variables, img, seg,
                                                                            flow)
    got = model.graph_forward(_t(img), _t(seg), _t(flow), dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        err = rel_l2(g.float().detach().numpy(), np.asarray(w, np.float32))
        assert err <= 2e-2, err


@pytest.mark.parametrize("prompt_type", ["highpass", "lowpass"])
def test_prompt_helpers_match_jax(prompt_type):
    x = np.random.default_rng(4).standard_normal((2, 20, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(pme.fft_prompt(torch.from_numpy(x), 0.25, prompt_type).numpy(),
                               np.asarray(jme.fft_prompt(jnp.asarray(x), 0.25, prompt_type)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pme.srm_filter(torch.from_numpy(x)).numpy(),
                               np.asarray(jme.srm_filter(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_attention_capture_matches_sow():
    """capture_attn: every block's probabilities, as flax's
    sow("intermediates", "attn") under mutable=["intermediates"]."""
    cfg = tiny(with_flow=True)
    variables = jax_variables(cfg, HEAD, 3)
    img, seg, flow = inputs(cfg, 3)
    want, inter = jme.MiTEVP(cfg, HEAD, capture_attn=True).apply(
        variables, img, seg, flow, mutable=["intermediates"])
    got, attn = port_model(cfg, HEAD, variables).graph_forward(
        _t(img), _t(seg), _t(flow), capture_attn=True)
    names = [f"block{s}.{d}" for s in range(1, 5) for d in range(cfg.depths[s - 1])]
    assert sorted(attn) == sorted(names)
    for name in names:
        s, d = name[5], name.split(".")[1]
        w = np.asarray(inter["intermediates"][f"block{s}_{d}"]["attn"]["attn"][0])
        a = attn[name].detach().numpy()
        assert a.shape == w.shape and a.shape[:2] == (B, cfg.num_heads[int(s) - 1])
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-6)


# -- train mode -------------------------------------------------------------------------

# prompt width C / 2: at C / 4 stage 1's prompt LayerNorm normalizes 2
# channels (output +-1 whatever its input), so the handcrafted generator's
# gradient there would be roundoff alone
TRAIN_CFG = tiny(with_flow=True, drop_path_rate=0.2, drop_rate=0.1, prompt_scale_factor=2)
# biases whose effect is a per-channel constant in front of a train-mode
# BatchNorm (the flow encoder's convs; the cross-attention LayerNorms' and
# the head's stage projections' biases, constant per channel through the
# resize, the projection and the 1x1 fuse conv): the batch mean removes
# them, so their gradient is zero up to roundoff on both sides
STRUCTURAL_ZEROS = (tuple(f"flow_encoder.conv{i}.bias" for i in (1, 2, 3, 4))
                    + ("cross_attn_s3.norm.bias", "cross_attn_s4.norm.bias")
                    + tuple(f"head.linear_c{i}.proj.bias" for i in (1, 2, 3, 4)))
TRAIN_HEAD = HeadConfig(embedding_dim=32, hidden=16, dropout=0.1)


def injected_masks(cfg, head, seed=5):
    """Seeded masks in the port's layout: DropPath factors {0, 1/keep} per
    block and branch, the blocks' dropout keep masks (attention output, MLP
    hidden, MLP output) and the head's channel keep mask."""
    rng = np.random.default_rng(seed)
    rates = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
    dp = []
    for r in rates:
        keep = 1.0 - r
        dp.append(tuple(torch.from_numpy((rng.random(B) < keep).astype(np.float32) / keep)
                        for _ in range(2)) if r > 0 else (torch.ones(B), torch.ones(B)))
    drop, n = [], 0
    for s in range(4):
        N = (cfg.img_size // (4 * 2 ** s)) ** 2
        C = cfg.embed_dims[s]
        for _ in range(cfg.depths[s]):
            drop.append(tuple(torch.from_numpy(rng.random((B, N, c)) >= cfg.drop_rate)
                              for c in (C, cfg.mlp_ratios[s] * C, C)))
            n += 1
    keep = torch.from_numpy(rng.random((B, head.embedding_dim)) >= head.dropout)
    return {"droppath": dp, "drop": drop, "dropout": keep}


def flax_train_apply(cfg, head, variables, params, img, seg, flow, masks):
    """JAX MiTEVP.apply(train=True) with the port's masks put in place of
    each DropPath and active nn.Dropout draw: DropPath calls in block order
    (attention branch, then MLP branch), the block dropouts in the order the
    flax module calls them (attention output, MLP hidden, MLP output)."""
    dp = [m for pair in masks["droppath"] for m in pair]
    drop = [m for triple in masks["drop"] for m in triple]
    calls = {"dp": 0, "drop": 0}

    def inject(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        if isinstance(mod, jme.DropPath) and mod.rate > 0:
            f = jnp.asarray(dp[calls["dp"]].numpy())
            calls["dp"] += 1
            keep = 1.0 - mod.rate
            kept = (f > 0).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
            return jnp.where(kept, x / keep, 0.0).astype(x.dtype)
        if isinstance(mod, jme.DropPath):
            calls["dp"] += 1
            return x
        if isinstance(mod, fnn.Dropout) and mod.rate > 0:
            if mod.scope.path[0] == "head":
                keep = jnp.asarray(masks["dropout"].numpy())[:, None, None, :]
            else:
                keep = jnp.asarray(drop[calls["drop"]].numpy())
                calls["drop"] += 1
            return jnp.where(keep, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(inject):
        (y, ya), upd = jme.MiTEVP(cfg, head).apply(
            {**variables, "params": params}, img, seg, flow, train=True,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
    assert calls == {"dp": 2 * sum(cfg.depths), "drop": 3 * sum(cfg.depths)}
    return y, ya, upd["batch_stats"]


@pytest.fixture(scope="module")
def train_ref():
    cfg, head = TRAIN_CFG, TRAIN_HEAD
    variables = jax_variables(cfg, head, 6)
    img, seg, flow = inputs(cfg, 6)
    masks = injected_masks(cfg, head)
    train, frozen, treedef = partition_params(variables["params"])

    def loss(train):
        y, ya, bs = flax_train_apply(cfg, head, variables, combine_params(train, frozen, treedef),
                                     img, seg, flow, masks)
        return jnp.sum(y ** 2) + jnp.sum(ya ** 2), (y, ya, bs)

    (_, (y, ya, bs)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(train)
    zeros = iter([np.zeros_like(np.asarray(f)) for f in frozen if f is not None])
    full = combine_params([None if a is None else np.asarray(a) for a in g],
                          [None if f is None else next(zeros) for f in frozen], treedef)
    grads = export_evp_state_dict(jax.tree.map(np.asarray, full), variables["batch_stats"])
    return variables, (img, seg, flow), masks, (np.asarray(y), np.asarray(ya),
                                               jax.tree.map(np.asarray, bs), grads)


def test_train_forward_bn_stats_and_gradients_match_jax(train_ref):
    variables, (img, seg, flow), masks, (jy, jya, jbs, jgrads) = train_ref
    model = port_model(TRAIN_CFG, TRAIN_HEAD, variables)
    freeze_trunk(model)
    (y, ya), stats = model.graph_forward(_t(img), _t(seg), _t(flow), train=True, masks=masks)
    assert rel_l2(y.detach().numpy(), jy) <= 1e-5 and rel_l2(ya.detach().numpy(), jya) <= 1e-5
    want = {f"flow_encoder.bn{i}": jbs["flow_encoder"][f"bn{i}"] for i in (1, 2, 3, 4)}
    want["head.linear_fuse.bn"] = jbs["head"]["fuse_bn"]
    assert sorted(stats) == sorted(want)
    for name, (mean, var) in stats.items():
        np.testing.assert_allclose(mean.numpy(), want[name]["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), want[name]["var"], rtol=1e-5, atol=1e-6)
    ((y ** 2).sum() + (ya ** 2).sum()).backward()
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert not [n for n, p in model.named_parameters() if not p.requires_grad and p.grad is not None]
    gmax = max(np.abs(jgrads[n]).max() for n in got)
    for n, g in got.items():
        w = jgrads[n]
        if n in STRUCTURAL_ZEROS:
            assert max(np.abs(g.numpy()).max(), np.abs(w).max()) <= 1e-5 * gmax, n
            continue
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= 1e-4, (n, err)
    assert len(got) > 40 and any(n.startswith("prompt_generator.handcrafted") for n in got)


def test_train_masks_drop_and_generator_draws():
    """The injected masks hold zeros and kept entries on every kind; with a
    generator instead, the same seed gives the same outputs and another seed
    other draws; without either, train mode refuses."""
    masks = injected_masks(TRAIN_CFG, TRAIN_HEAD)
    flat = torch.cat([torch.cat(m) for m in masks["droppath"]])
    assert (flat == 0).any() and (flat > 1).any()
    assert not masks["dropout"].all() and not all(m.all() for t in masks["drop"] for m in t)
    model = MiTEVP(TRAIN_CFG, TRAIN_HEAD, seed=2, device="cpu")
    img, seg, flow = (_t(a) for a in inputs(TRAIN_CFG, 7))
    run = lambda s: model.graph_forward(img, seg, flow, train=True,
                                        generator=torch.Generator().manual_seed(s))[0][0].detach()
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="generator or masks"):
        model.graph_forward(img, seg, flow, train=True)


def test_every_config_builds_and_fused_graphs_refuse_what_they_do_not_compute():
    """Construction takes every variant; the fused serving and training
    graphs keep refusing prompt variants; without flow they skip the flow
    branch as JAX's graph does."""
    from surgical_tpu_torch.models.mit_fused import fused_forward
    from surgical_tpu_torch.models.mit_train import fused_train_forward

    img, seg, flow = (torch.zeros(B, 64, 64, c) for c in (3, 3, 2))
    for name, kw in VARIANTS.items():
        model = MiTEVP(tiny(**kw), HEAD, device="cpu")
        assert hasattr(model, "flow_encoder") == model.cfg.with_flow, name
        if name in ("gaussian", "gaussian_flow"):
            continue
        with pytest.raises(NotImplementedError, match="fused graphs compute the default"):
            fused_forward(model, img, seg, flow)
        with pytest.raises(NotImplementedError, match="fused graphs compute the default"):
            fused_train_forward(model, img, seg, flow, masks={"droppath": [], "dropout": None})
    model = MiTEVP(tiny(), HEAD, device="cpu")
    a = fused_forward(model, img, seg, flow)
    b = fused_forward(model, img, seg, None)
    assert a.shape == (B, HEAD.embedding_dim) and torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="block dropout"):
        fused_train_forward(MiTEVP(dataclasses.replace(tiny(), drop_rate=0.1), HEAD,
                                   device="cpu"), img, seg, flow)


def test_extraction_route_follows_the_variant_rule():
    """make_raw_feature_fn's graph, read from its decision: on the card a
    preset size takes the fused kernels and ``tiny`` the flax graph, as
    JAX's _use_fused_default; on the CPU the serving graph's plain versions
    (JAX runs the flax graph there). The flax route's features are
    graph_forward's at bf16."""
    from surgical_tpu_torch.train.extract import (make_raw_feature_fn, use_fused_default,
                                                  wire_dequant)

    for variant in ("b0", "b3", "b5"):
        assert use_fused_default(BackboneConfig.preset(variant), torch.device("cuda"))
        assert use_fused_default(BackboneConfig.preset(variant), "cpu")
    assert not use_fused_default(BackboneConfig.preset("tiny"), "cuda")
    assert use_fused_default(BackboneConfig.preset("tiny"), "cpu")
    model = MiTEVP(tiny(), HEAD, device="cpu")
    assert make_raw_feature_fn(model).use_fused
    fn = make_raw_feature_fn(model, use_fused=False)
    assert not fn.use_fused
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (B, 64, 64, 1), dtype=np.uint8)
    x, s = wire_dequant("cpu")(torch.from_numpy(img), torch.from_numpy(seg))
    want = model.graph_forward(x, s, return_features=True, dtype=torch.bfloat16)
    got = fn(img, seg, None)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, want.to(torch.float16), rtol=0, atol=0)
