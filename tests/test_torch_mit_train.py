"""The port's fused training forward (``models/mit_train.py``) against the
JAX package's ``fused_train_forward`` (Pallas train kernels in interpret
mode), tiny preset in fp32 with drop path 0.1 and head dropout 0.1, the
DropPath and dropout masks drawn by JAX's own key derivation and injected
into the port.

Stated bounds, those of tests/test_mit_train.py (fused vs flax graph):
logits and anticipation rtol 2e-4 / atol 2e-5; new BatchNorm statistics
1e-5; trainable gradients, divided by the global max |gradient|, rtol 5e-3 /
atol 1e-5. Both sides compute in fp32; they differ by summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.models import mit_train as jmt
from surgical_tpu.models.convert import import_evp_state_dict
from surgical_tpu.train.backbone import combine_params, partition_params
from surgical_tpu_torch.models.convert import export_evp_state_dict, load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP, _init_weights
from surgical_tpu_torch.models.mit_train import (draw_masks, fused_train_forward,
                                                 train_block_weights, write_bn_stats)
from surgical_tpu_torch.train.backbone import freeze_trunk

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

CFG = BackboneConfig.preset("tiny", drop_path_rate=0.1, img_size=64)
HEAD = HeadConfig(embedding_dim=64, hidden=32, dropout=0.1)
B, KEY = 4, 7


def jax_masks(key, cfg=CFG, head=HEAD, batch=B):
    """The masks JAX's fused_train_forward draws from ``key``
    (mit_train.py:107-110, :212), in the port's ``masks=`` layout."""
    rng_dp, rng_drop = jax.random.split(key)
    dp = jmt._droppath_masks(rng_dp, [float(r) for r in np.linspace(
        0, cfg.drop_path_rate, sum(cfg.depths))], batch)
    keep = jax.random.bernoulli(rng_drop, 1.0 - head.dropout, (batch, 1, 1, head.embedding_dim))
    t = lambda a: torch.from_numpy(np.array(a))
    return {"droppath": [(t(m1), t(m2)) for m1, m2 in dp],
            "dropout": t(keep).reshape(batch, head.embedding_dim)}


def seeded_variables(cfg, head, seed):
    """JAX MiT-EVP (params, batch_stats) of numpy arrays: a seeded port
    model's weights through the JAX package's importer (much faster here
    than a flax init), every leaf perturbed so that no bias is zero, and
    non-trivial BatchNorm statistics."""
    model = MiTEVP(cfg, head, seed=seed, device="cpu")
    # the reference's init scheme in every module: the weights these parity
    # bounds were measured on (the model itself draws the head and the
    # cross-attention with flax's lecun-normal, as the JAX model does, which
    # scales up every gradient into the trunk; at the tiny preset's 2-channel
    # prompt LayerNorm the handcrafted generator's gradient is pure roundoff)
    _init_weights(model, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = import_evp_state_dict(sd, cfg.depths)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32), params)
    stats = jax.tree.map(np.asarray, stats)
    for group in stats.values():
        for bn in group.values():
            bn["mean"] = 0.1 * rng.standard_normal(bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def setup():
    jax.config.update("jax_default_matmul_precision", "highest")
    variables = seeded_variables(CFG, HEAD, 3)
    rng = np.random.default_rng(3)
    img, seg, flow = (rng.standard_normal((B, 64, 64, c)).astype(np.float32) for c in (3, 3, 2))
    model = MiTEVP(CFG, HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    freeze_trunk(model)
    return variables, model, img, seg, flow


@pytest.fixture(scope="module")
def jax_ref(setup):
    """JAX outputs, new batch stats and the trainable gradients of
    sum(y^2) + sum(ya^2) (one traced forward and backward), the gradients
    in the port's state-dict names."""
    variables, _, img, seg, flow = setup
    train, frozen, treedef = partition_params(variables["params"])

    def loss(train):
        y, ya, bs = jmt.fused_train_forward(
            combine_params(train, frozen, treedef), variables["batch_stats"], jnp.asarray(img),
            jnp.asarray(seg), jnp.asarray(flow), jax.random.key(KEY), CFG, HEAD,
            compute_dtype=jnp.float32, interpret=True)
        return jnp.sum(y ** 2) + jnp.sum(ya ** 2), (y, ya, bs)

    (_, (y, ya, bs)), g = jax.value_and_grad(loss, has_aux=True)(train)
    zeros = iter([np.zeros_like(np.asarray(f)) for f in frozen if f is not None])
    full = combine_params([None if a is None else np.asarray(a) for a in g],
                          [None if f is None else next(zeros) for f in frozen], treedef)
    grads = export_evp_state_dict(jax.tree.map(np.asarray, full), variables["batch_stats"])
    return np.asarray(y), np.asarray(ya), jax.tree.map(np.asarray, bs), grads


def _port_forward(model, img, seg, flow):
    t = torch.from_numpy
    return fused_train_forward(model, t(img), t(seg), t(flow), masks=jax_masks(
        jax.random.key(KEY)), dtype=torch.float32)


def test_masks_drop_some_branches():
    masks = jax_masks(jax.random.key(KEY))
    flat = torch.cat([torch.cat(m) for m in masks["droppath"]])
    assert (flat == 0).any() and (flat > 1).any()  # both 0 and 1/keep occur
    assert not masks["dropout"].all()


def test_train_forward_and_bn_stats_match_jax(setup, jax_ref):
    variables, model, img, seg, flow = setup
    jy, jya, jbs, _ = jax_ref
    y, ya, stats = _port_forward(model, img, seg, flow)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ya.detach().numpy(), np.asarray(jya), rtol=2e-4, atol=2e-5)
    want = {f"flow_encoder.bn{i}": jbs["flow_encoder"][f"bn{i}"] for i in (1, 2, 3, 4)}
    want["head.linear_fuse.bn"] = jbs["head"]["fuse_bn"]
    assert sorted(stats) == sorted(want)
    for name, (mean, var) in stats.items():
        np.testing.assert_allclose(mean.numpy(), np.asarray(want[name]["mean"]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(var.numpy(), np.asarray(want[name]["var"]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the buffers move only when the caller writes the statistics
    bn = model.flow_encoder.bn2
    before = bn.running_var.clone()
    write_bn_stats(model, stats)
    assert not torch.equal(bn.running_var, before)
    torch.testing.assert_close(bn.running_var, stats["flow_encoder.bn2"][1], rtol=0, atol=0)
    load_evp_params(model, variables["params"], variables["batch_stats"])


def test_trainable_gradients_match_jax(setup, jax_ref):
    variables, model, img, seg, flow = setup
    want = jax_ref[3]
    model.zero_grad(set_to_none=True)
    y, ya, _ = _port_forward(model, img, seg, flow)
    ((y ** 2).sum() + (ya ** 2).sum()).backward()
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    frozen_grads = [n for n, p in model.named_parameters() if not p.requires_grad and
                    p.grad is not None]
    assert not frozen_grads
    gmax = max(np.abs(want[n]).max() for n in got)
    for n, gr in got.items():
        assert gr is not None, n
        np.testing.assert_allclose(gr.numpy() / gmax, want[n] / gmax, rtol=5e-3, atol=1e-5,
                                   err_msg=n)
    assert len(got) > 40 and any(n.startswith("prompt_generator.handcrafted") for n in got)


def test_generator_draws_are_reproducible(setup):
    """With a generator instead of injected masks: the same seed gives the
    same logits, another seed other DropPath and dropout draws."""
    _, model, img, seg, flow = setup
    t = torch.from_numpy
    run = lambda s: fused_train_forward(model, t(img), t(seg), t(flow),
                                        generator=torch.Generator().manual_seed(s),
                                        dtype=torch.float32)[0].detach()
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    m = draw_masks(dataclasses.replace(CFG, drop_path_rate=0.5), HEAD, 512,
                   torch.Generator().manual_seed(0))
    last = torch.cat(m["droppath"][-1])
    assert set(last.unique().tolist()) == {0.0, 2.0}
    assert abs(m["dropout"].float().mean().item() - 0.9) < 0.01
    with pytest.raises(ValueError, match="generator or masks"):
        fused_train_forward(model, t(img), t(seg), t(flow), dtype=torch.float32)


def test_train_block_weights_keyed_on_the_trunk_alone():
    """Kept when a prompt-generator parameter is written in place (the
    trainable parameters change every step), rebuilt with the new values
    when a trunk block's is."""
    model = MiTEVP(CFG, HEAD, seed=0, device="cpu")
    first = train_block_weights(model, torch.bfloat16)
    with torch.no_grad():
        model.prompt_generator.shared_mlp1.weight.add_(1.0)
    assert train_block_weights(model, torch.bfloat16) is first
    with torch.no_grad():
        model.block2[0].attn.q.weight.add_(1.0)
    second = train_block_weights(model, torch.bfloat16)
    assert second is not first
    want = model.block2[0].attn.q.weight.t().to(torch.bfloat16)
    torch.testing.assert_close(second[2][0]["wq"], want, rtol=0, atol=0)
    assert train_block_weights(model, torch.float32) is not second  # the dtype is keyed too
