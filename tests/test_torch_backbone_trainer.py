"""The port's BackboneTrainer against the JAX train step on both graphs, its
freeze semantics, its evaluator, and ``cli train-backbone`` on a small PNG
work dir (CPU).

The JAX step is assembled as ``BackboneTrainer._train_step_impl``
(surgical_tpu/train/backbone.py:207-247) does it: dequant, the batch
augmentation, ``fused_train_forward`` (Pallas kernels in interpret mode),
sum-reduction CE + SmoothL1, optax SGD with momentum 0.9 on the trainable
partition. The tiny model runs in fp32 on both sides, the augmentation
parameters and the DropPath / dropout masks of JAX's key derivation are
injected into the port.

Stated bound after three steps: every parameter and BatchNorm statistic
within rtol 1e-4 / atol 1e-6 of JAX's (fp32 on both sides, summation
orders differ; measured here: max abs difference 2.4e-7, on a BatchNorm
running variance of ~1).

The flax graph (``use_fused=False``, the default) is held to JAX's own
``BackboneTrainer._train_step_impl`` (the flax model in train mode) for
three steps with the augmentation parameters injected and the DropPath and
head-dropout draws replaced on both sides by the same masks (flax's through
``flax.linen.intercept_methods``), at the same bound; ``evaluate`` to JAX's
``BackboneTrainer.evaluate`` on the same weights.
"""

import dataclasses
import json
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.core.config import OptimConfig as JaxOptimConfig
from surgical_tpu.core.config import TrainConfig as JaxTrainConfig
from surgical_tpu.data import transforms as jtf
from surgical_tpu.models import mit_evp as jme
from surgical_tpu.models import mit_train as jmt
from surgical_tpu.train import losses as jlosses
from surgical_tpu.train.backbone import BackboneTrainer as JaxBackboneTrainer
from surgical_tpu.train.backbone import combine_params, partition_params
from surgical_tpu.train.optim import build_optimizer as jax_build_optimizer
from surgical_tpu_torch import cli
from surgical_tpu_torch.core.checkpoint import CheckpointStore
from surgical_tpu_torch.core.config import OptimConfig, TrainConfig
from surgical_tpu_torch.data.transforms import AugConfig, AugParams
from surgical_tpu_torch.models.convert import (export_evp_state_dict, load_evp_params,
                                               load_mit_trunk, load_torch_pth)
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.train import backbone as pbb
from test_torch_mit_train import jax_masks, seeded_variables

CFG = BackboneConfig.preset("tiny", drop_path_rate=0.1, img_size=64)
# The flax-graph steps run at prompt width C / 2: at the tiny preset's C / 4
# stage 1's prompt LayerNorm normalizes 2 channels, whose output is +-1 for
# any input, so the handcrafted generator's gradient there is roundoff alone
# and differs between any two summation orders.
FLAX_CFG = dataclasses.replace(CFG, prompt_scale_factor=2)
HEAD = HeadConfig(embedding_dim=64, hidden=32, dropout=0.1)
JAUG, PAUG = jtf.AugConfig(resize=72, crop=64), AugConfig(resize=72, crop=64)
B, STEPS, LR = 2, 3, 0.05


def _wire_batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (B, 72, 72, 3), dtype=np.uint8),
             rng.integers(0, 256, (B, 72, 72, 1), dtype=np.uint8),
             rng.standard_normal((B, 72, 72, 2)).astype(np.float16),
             rng.integers(0, 7, B).astype(np.int32),
             rng.uniform(0, 1, (B, 7)).astype(np.float32)) for _ in range(STEPS)]


def _jax_steps(variables, batches):
    """STEPS JAX train steps; returns (params, batch_stats) and each step's
    injected draws (augmentation params, masks) for the port."""
    tx = jax_build_optimizer(JaxOptimConfig(name="sgd", lr=LR, weight_decay=0.0,
                                            grad_clip_norm=None))
    params, bs = variables["params"], variables["batch_stats"]
    train, frozen, treedef = partition_params(params)
    opt_state = tx.init(train)

    @jax.jit
    def step(train, bs, opt_state, img_u8, seg_u8, flow_f16, labels, ant, key):
        img = img_u8.astype(jnp.float32) / 255.0
        seg = jnp.broadcast_to(seg_u8.astype(jnp.float32) / 255.0, img.shape)
        img, seg, flow = jtf.train_preprocess_batch(img, seg, flow_f16.astype(jnp.float32),
                                                    jax.random.fold_in(key, 0), JAUG)

        def loss_fn(train):
            y, ya, new_bs = jmt.fused_train_forward(
                combine_params(train, frozen, treedef), bs, img, seg, flow,
                jax.random.fold_in(key, 1), CFG, HEAD, compute_dtype=jnp.float32,
                interpret=True)
            ce = jlosses.weighted_cross_entropy(y, labels, reduction="sum")
            return ce + jlosses.smooth_l1(ya, ant, reduction="sum"), new_bs

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(train)
        updates, opt_state = tx.update(grads, opt_state, train)
        return optax.apply_updates(train, updates), new_bs, opt_state, loss

    draws, losses = [], []
    for bi, (img, seg, flow, labels, ant) in enumerate(batches):
        key = jax.random.key(100 + bi)
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.fold_in(key, 0), i))(
            jnp.arange(B))
        ap = jax.vmap(lambda k: jtf.draw_params(k, JAUG))(keys)
        draws.append((AugParams(*(torch.from_numpy(np.array(f)) for f in ap)),
                      jax_masks(jax.random.fold_in(key, 1), CFG, HEAD, B)))
        train, bs, opt_state, loss = step(train, bs, opt_state, img, seg, flow, labels, ant, key)
        losses.append(float(loss))
    params = jax.tree.map(np.asarray, combine_params(train, frozen, treedef))
    return params, jax.tree.map(np.asarray, bs), draws, losses


def _port_trainer(variables, lr=LR, use_fused=True, cfg=CFG):
    model = MiTEVP(cfg, HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    trainer = pbb.BackboneTrainer(
        model, TrainConfig(optim=OptimConfig(name="sgd", lr=lr, weight_decay=0.0,
                                             grad_clip_norm=None)),
        aug_cfg=PAUG, use_fused=use_fused, compute_dtype=torch.float32)
    trainer.init()
    return model, trainer


def _step_masks(seed, cfg=FLAX_CFG):
    """Seeded DropPath factors {0, 1/keep} per block and branch and the
    head's channel keep mask, in the port's ``masks=`` layout."""
    rng = np.random.default_rng(seed)
    dp = []
    for r in np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)):
        keep = 1.0 - r
        dp.append(tuple(torch.from_numpy((rng.random(B) < keep).astype(np.float32) / keep)
                        for _ in range(2)))
    return {"droppath": dp,
            "dropout": torch.from_numpy(rng.random((B, HEAD.embedding_dim)) >= HEAD.dropout)}


def _jax_flax_steps(variables, batches):
    """STEPS of JAX's BackboneTrainer._train_step_impl on the flax model
    (fp32), each DropPath and head-dropout draw replaced by ``_step_masks``;
    returns (params, batch_stats), the port's injected draws and the losses."""
    jt = JaxBackboneTrainer(jme.MiTEVP(FLAX_CFG, HEAD), JaxTrainConfig(), aug_cfg=JAUG)
    jt._tx = jax_build_optimizer(JaxOptimConfig(name="sgd", lr=LR, weight_decay=0.0,
                                                grad_clip_norm=None))
    params, bs = variables["params"], variables["batch_stats"]
    opt_state = jt._tx.init(partition_params(params)[0])

    def step(params, bs, opt_state, img, seg, flow, labels, ant, key, dp, keep):
        calls = iter(dp)

        def inject(next_fun, args, kwargs, context):
            mod, x = context.module, args[0] if args else None
            if context.method_name == "__call__" and isinstance(mod, jme.DropPath):
                f = next(calls)
                if mod.rate == 0.0:
                    return x
                kept = (f > 0).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
                return jnp.where(kept, x / (1.0 - mod.rate), 0.0).astype(x.dtype)
            if (context.method_name == "__call__" and isinstance(mod, fnn.Dropout)
                    and mod.rate > 0):
                return jnp.where(keep[:, None, None, :], x / (1.0 - mod.rate), 0.0
                                 ).astype(x.dtype)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(inject):
            return jt._train_step_impl(params, bs, opt_state, img, seg, flow, labels, ant, key)

    step = jax.jit(step)
    draws, losses = [], []
    for bi, (img, seg, flow, labels, ant) in enumerate(batches):
        key = jax.random.key(200 + bi)
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.fold_in(key, 0), i))(
            jnp.arange(B))
        ap = jax.vmap(lambda k: jtf.draw_params(k, JAUG))(keys)
        masks = _step_masks(bi)
        dp = [jnp.asarray(m.numpy()) for pair in masks["droppath"] for m in pair]
        params, bs, opt_state, loss, *_ = step(params, bs, opt_state, img, seg, flow, labels,
                                               ant, key, dp, jnp.asarray(masks["dropout"].numpy()))
        draws.append((AugParams(*(torch.from_numpy(np.array(f)) for f in ap)), masks))
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bs), draws, losses, jt


@pytest.fixture(scope="module")
def setup():
    jax.config.update("jax_default_matmul_precision", "highest")
    return seeded_variables(CFG, HEAD, 5), _wire_batches()


def test_three_steps_match_jax(setup):
    variables, batches = setup
    jparams, jbs, draws, jlosses_ = _jax_steps(variables, batches)
    model, trainer = _port_trainer(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for bi, (batch, (ap, masks)) in enumerate(zip(batches, draws)):
        out = trainer.train_step(*batch, epoch=0, step=bi, aug_params=ap, masks=masks)
        np.testing.assert_allclose(out["loss"].item(), jlosses_[bi], rtol=1e-5)
    want = export_evp_state_dict(jparams, jbs)
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-6, err_msg=k)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    # a conv bias right before a train-mode BatchNorm has a structurally
    # zero gradient (the batch mean removes it); every other leaf moves
    assert trainable - moved == {f"flow_encoder.conv{i}.bias" for i in (1, 2, 3, 4)}
    assert all(pbb.is_trainable(k) for k in moved)  # the trunk is bit-unchanged


def test_flax_graph_steps_match_jax_train_step(setup):
    """use_fused=False (the default): three steps against JAX's own train
    step on the flax model, then evaluate against JAX's evaluate."""
    batches = setup[1]
    variables = seeded_variables(FLAX_CFG, HEAD, 6)
    jparams, jbs, draws, jlosses_, jt = _jax_flax_steps(variables, batches)
    model, trainer = _port_trainer(variables, use_fused=False, cfg=FLAX_CFG)
    assert not trainer.use_fused
    for bi, (batch, (ap, masks)) in enumerate(zip(batches, draws)):
        out = trainer.train_step(*batch, epoch=0, step=bi, aug_params=ap, masks=masks)
        np.testing.assert_allclose(out["loss"].item(), jlosses_[bi], rtol=1e-5)
    want = export_evp_state_dict(jparams, jbs)
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=1e-6, err_msg=k)
    # the evaluator: the flax graph in eval mode on the trained weights
    rng = np.random.default_rng(9)
    ev = [(rng.integers(0, 256, (4, 72, 72, 3), dtype=np.uint8),
           rng.integers(0, 256, (4, 72, 72, 1), dtype=np.uint8),
           rng.standard_normal((4, 72, 72, 2)).astype(np.float16),
           rng.integers(0, 7, 4).astype(np.int32),
           rng.uniform(0, 1, (4, 7)).astype(np.float32)) for _ in range(2)]
    jm = jt.evaluate((jparams, jbs), ev, num_each=[5, 3])
    pm = trainer.evaluate(ev, num_each=[5, 3])
    y, _ = trainer.eval_step(*ev[0][:3])
    jy, _ = jt._eval_step(jparams, jbs, *ev[0][:3])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    assert pm.keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_freeze_semantics_and_lr0_ablation(setup):
    """Only TRAINABLE_KEYS train; the optimizer holds only them; lr = 0
    leaves every parameter bit-unchanged while the BatchNorm statistics
    still move."""
    variables, batches = setup
    model, trainer = _port_trainer(variables, lr=0.0)
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    assert names == {n for n, _ in model.named_parameters()
                     if n.split(".")[0] in pbb.TRAINABLE_KEYS}
    assert not any(n.startswith(("block", "norm", "patch_embed")) for n in names)
    held = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for n, p in model.named_parameters() if n in names}
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    bn0 = model.head.linear_fuse.bn.running_mean.clone()
    out = trainer.train_step(*batches[0], epoch=0, step=0)
    assert np.isfinite(out["loss"].item())
    for n, p in model.named_parameters():
        assert torch.equal(p, params0[n]), n
    assert not torch.equal(model.head.linear_fuse.bn.running_mean, bn0)


def test_frozen_trunk_is_enforced(monkeypatch):
    model = MiTEVP(BackboneConfig.preset("tiny"), HeadConfig(embedding_dim=32, hidden=16),
                   device="cpu")
    monkeypatch.setattr(pbb, "TRAINABLE_KEYS", pbb.TRAINABLE_KEYS + ("block1",))
    with pytest.raises(AssertionError, match="frozen trunk"):
        pbb.freeze_trunk(model)
    with pytest.raises(AssertionError, match="frozen trunk"):
        pbb.BackboneTrainer(model, TrainConfig(), use_fused=True).init()
    # the flax graph differentiates every parameter: a trainable trunk block
    # is the recipe's business, as in JAX (asserted only under use_fused)
    opt = pbb.BackboneTrainer(model, TrainConfig(), use_fused=False).init()
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(model.block1[0].attn.q.weight) in held


def test_early_stop():
    es = pbb.EarlyStop(0.5)
    assert not es.update(0.7) and not es.stopped
    assert es.update(0.4) and es.update(0.9)  # stays stopped


# -- cli train-backbone ---------------------------------------------------------------

def _png_work(root):
    """A work dir in the JAX CLI's layout over tiny JPEG frames with PNG
    segmaps and .npy flow: train 2 videos x 3 frames, val and test 1 x 3."""
    from PIL import Image

    rng = np.random.default_rng(11)
    idx = root / "index"
    idx.mkdir(parents=True)
    vid = 0
    for split, videos in (("train", 2), ("val", 1), ("test", 1)):
        paths, labels = [], []
        for _ in range(videos):
            vid += 1
            for f in range(3):
                p = root / "data" / "cutMargin" / str(vid) / f"{f}.jpg"
                p.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(p)
                s = root / "data" / "ss_Bimasks_pos_ep10" / str(vid) / f"{f}.png"
                s.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rng.integers(0, 256, (24, 24), dtype=np.uint8)).save(s)
                fl = root / "data" / "raft_flow_npy" / str(vid) / f"{f}.npy"
                fl.parent.mkdir(parents=True, exist_ok=True)
                np.save(fl, rng.standard_normal((12, 12, 2)).astype(np.float32))
                paths.append(str(p))
                labels.append(np.concatenate([[rng.integers(0, 7)], rng.integers(0, 2, 7),
                                              rng.uniform(0, 1, 7)]))
        np.save(idx / f"{split}_labels.npy", np.asarray(labels, np.float32))
        np.save(idx / f"{split}_num_each.npy", np.full(videos, 3))
        np.save(idx / f"{split}_video_ids.npy", np.arange(vid - videos + 1, vid + 1))
        (idx / f"{split}_paths.json").write_text(json.dumps(paths))
    return root


def _cli(work, *extra):
    return cli.main(["train-backbone", "--work", str(work), "--fused", "--device", "cpu",
                     "--variant", "tiny", "--batch-size", "4", "--midval-batches", "1",
                     *extra])


def test_cli_train_backbone_resume(tmp_path, capsys):
    """One epoch, then --resume to epoch 2, ends bit-identical to two epochs
    in one run: the model, its BatchNorm statistics and the SGD momentum are
    all restored, and every draw depends on (seed, epoch, step) only."""
    one = _png_work(tmp_path / "one")
    shutil.copytree(one, tmp_path / "two", symlinks=True)
    two = tmp_path / "two"
    assert _cli(one, "--epochs", "2") == 0
    assert _cli(two, "--epochs", "1") == 0
    store = CheckpointStore(str(two / "ckpt" / "backbone"))
    assert store.steps() == [0] and store.has_aux(0)
    m = store.manifest(0)["metrics"]
    assert 0.0 <= m["val_acc"] <= 1.0 and "test_acc" in m and m["train_loss"] > 0
    assert _cli(two, "--epochs", "2", "--resume") == 0
    assert "resumed full train state from epoch 0" in capsys.readouterr().out
    a = torch.load(one / "ckpt" / "backbone" / "step_00000001.pt", weights_only=True)
    b = torch.load(two / "ckpt" / "backbone" / "step_00000001.pt", weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa = CheckpointStore(str(one / "ckpt" / "backbone")).restore_aux(1)["optimizer"]
    ob = store.restore_aux(1)["optimizer"]
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"]) > 40
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
    # between the epochs the head trained and the frozen trunk did not move
    first = torch.load(two / "ckpt" / "backbone" / "step_00000000.pt", weights_only=True)
    assert any(not torch.equal(first[k], b[k]) for k in b if k.startswith("head."))
    assert all(torch.equal(first[k], b[k]) for k in b if k.startswith("block"))
    # the stage-1 -> stage-2 hand-off: a fresh run initialized from that store
    three = tmp_path / "three"
    shutil.copytree(one / "index", three / "index")
    assert _cli(three, "--epochs", "1", "--init-from", str(one / "ckpt" / "backbone")) == 0
    best = CheckpointStore(str(one / "ckpt" / "backbone")).best_step("val_acc")
    assert f"step {best} (fresh optimizer)" in capsys.readouterr().out


def test_pretrained_trunk_loads_by_key_name(tmp_path):
    """--pretrained: a mit_b*.pth (DataParallel prefixes, a state_dict
    wrapper, an ImageNet head) fills the trunk only; a misfit key raises."""
    cfg, head = BackboneConfig.preset("tiny"), HeadConfig(embedding_dim=32, hidden=16)
    src = MiTEVP(cfg, head, seed=1, device="cpu").state_dict()
    sd = {f"module.{k}": v for k, v in src.items() if k.split(".")[0][:-1] in
          ("patch_embed", "block", "norm")}
    sd["module.head.weight"] = torch.zeros(1000, 32)
    torch.save({"state_dict": sd}, tmp_path / "mit.pth")
    dst = MiTEVP(cfg, head, seed=2, device="cpu")
    fresh = {k: v.clone() for k, v in dst.state_dict().items()}
    keys = load_mit_trunk(dst, load_torch_pth(str(tmp_path / "mit.pth")))
    got = dst.state_dict()
    assert len(keys) == len(sd) - 1
    for k in got:
        want = src[k] if k in keys else fresh[k]
        assert torch.equal(got[k], want), k
    assert not torch.equal(got["head.fc.0.weight"], src["head.fc.0.weight"])
    bad = {"block1.0.attn.q.weight": torch.zeros(3, 3)}
    with pytest.raises(KeyError, match="does not fit"):
        load_mit_trunk(dst, bad)


@pytest.fixture
def one_thread():
    """One intra-op thread for a run of many small ops (the suite runs its
    files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli_flax(work, *extra):
    return cli.main(["train-backbone", "--work", str(work), "--device", "cpu",
                     "--variant", "tiny", "--batch-size", "4", "--midval-batches", "1", *extra])


def test_cli_train_backbone_flax_graph_resume(tmp_path, capsys, one_thread):
    """Without --fused the CLI trains on the flax graph; one epoch, then
    --resume to epoch 2, ends bit-identical to two epochs in one run."""
    one = _png_work(tmp_path / "one")
    shutil.copytree(one, tmp_path / "two", symlinks=True)
    two = tmp_path / "two"
    assert _cli_flax(one, "--epochs", "2") == 0
    assert _cli_flax(two, "--epochs", "1") == 0
    assert _cli_flax(two, "--epochs", "2", "--resume") == 0
    assert "resumed full train state from epoch 0" in capsys.readouterr().out
    a = torch.load(one / "ckpt" / "backbone" / "step_00000001.pt", weights_only=True)
    b = torch.load(two / "ckpt" / "backbone" / "step_00000001.pt", weights_only=True)
    first = torch.load(two / "ckpt" / "backbone" / "step_00000000.pt", weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa = CheckpointStore(str(one / "ckpt" / "backbone")).restore_aux(1)["optimizer"]
    ob = CheckpointStore(str(two / "ckpt" / "backbone")).restore_aux(1)["optimizer"]
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"]) > 40
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
    assert any(not torch.equal(first[k], b[k]) for k in b if k.startswith("prompt_generator."))
    assert all(torch.equal(first[k], b[k]) for k in b if k.startswith("block"))


def test_cli_train_backbone_refuses_what_is_not_ported(tmp_path):
    """--no-flow trains on the flax graph (a model without the flow encoder
    and fusions); the fused trunk still refuses a prompt configuration its
    kernels do not compute."""
    work = _png_work(tmp_path)
    assert _cli_flax(work, "--no-flow", "--epochs", "1") == 0
    sd = torch.load(work / "ckpt" / "backbone" / "step_00000000.pt", weights_only=True)
    assert not any(k.startswith(("flow_encoder", "cross_attn")) for k in sd)
    model = MiTEVP(BackboneConfig.preset("tiny", input_type="srm"),
                   HeadConfig(embedding_dim=32, hidden=16), device="cpu")
    batch = _wire_batches()[0]
    trainer = pbb.BackboneTrainer(model, TrainConfig(), aug_cfg=PAUG, use_fused=True)
    trainer.init()
    with pytest.raises(NotImplementedError, match="fused graphs compute the default"):
        trainer.train_step(*batch)
    trainer = pbb.BackboneTrainer(model, TrainConfig(), aug_cfg=PAUG)
    trainer.init()
    assert np.isfinite(trainer.train_step(*batch)["loss"].item())
