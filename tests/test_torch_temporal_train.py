"""Temporal and refiner training in the port against the JAX package's, and
the port's ``train-temporal`` / ``train-refiner`` / ``selfcheck`` verbs.

Tiny sizes (MS-TCN 2 stages x 3 layers, f_maps 8; Mamba 2 layers, d_model
16, d_state 64; the refiner f_maps 8; f_dim 16; videos of at most 64 frames),
inputs from numpy with a seed, weights from a JAX init through the
``export_*_state_dict`` functions. JAX runs at "highest" matmul precision
(tests/conftest.py).

Stated bounds: the losses 1e-6 (fp32, same formulas); one training step
(loss, its parts, the count of correct frames, every updated parameter)
1e-5 where the video's length equals its bucket, so both sides run the same
length, and 1e-4 for Mamba where JAX pads to the bucket and runs its
associative scan (ROADMAP, known differences); dropout bit for bit from the
same mask; model outputs under flax's own dropout masks 1e-5 (MS-TCN) and
1e-4 (Mamba).
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core import rng as jax_rng
from surgical_tpu.core.config import (MambaConfig, MSTCNConfig, OptimConfig, RefinerConfig,
                                      TrainConfig)
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.train import losses as jax_losses
from surgical_tpu.train.refiner import RefinerTrainer as JaxRefinerTrainer
from surgical_tpu.train.temporal import TemporalTrainer as JaxTemporalTrainer
from surgical_tpu_torch import cli
from surgical_tpu_torch.core import config as port_config
from surgical_tpu_torch.core import rng as port_rng
from surgical_tpu_torch.core.checkpoint import CheckpointStore
from surgical_tpu_torch.data.feature_store import FeatureStore
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mstcn import DropoutMasks, MultiStageTCN, dropout
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.train import losses
from surgical_tpu_torch.train.refiner import RefinerTrainer
from surgical_tpu_torch.train.temporal import (TemporalTrainer, VideoDataset, collate,
                                               dropout_masks, make_batches)

F_DIM = 16
MSTCN = dict(stages=2, layers=3, f_maps=8, f_dim=F_DIM)
MAMBA = dict(layers=2, d_model=16, d_state=64, f_dim=F_DIM)
REFINER = dict(f_maps=8, f_dim=F_DIM, len_q=6)
BUCKETS = (32, 64)
EXACT, PADDED_MAMBA = 1e-5, 1e-4


def _ds(lengths, seed=0):
    """A VideoDataset of separable features (label + noise) over an in-memory
    store, phases sorted within each video."""
    rng = np.random.default_rng(seed)
    labels = np.concatenate([np.sort(rng.integers(0, 7, L)) for L in lengths]).astype(np.int32)
    n = len(labels)
    feats = (rng.standard_normal((n, F_DIM)) * 0.5 + labels[:, None]).astype(np.float32)
    ant = rng.uniform(0, 1, (n, 7)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    store = FeatureStore(feats, np.asarray(lengths), starts, {})
    return VideoDataset(store, labels, ant, np.asarray(lengths), starts)


def _jax_model(kind, dropout_rate=0.0, backend="auto"):
    if kind == "mstcn":
        return JaxMSTCN(MSTCNConfig(**MSTCN, dropout=dropout_rate))
    return JaxMamba(MambaConfig(**MAMBA, dropout=dropout_rate), backend=backend)


def _port_model(kind, params, dropout_rate=0.0):
    if kind == "mstcn":
        m = MultiStageTCN(port_config.MSTCNConfig(**MSTCN, dropout=dropout_rate), device="cpu")
        convert.load_mstcn_params(m, params)
    else:
        m = CausalMambaModel(port_config.MambaConfig(**MAMBA, dropout=dropout_rate), device="cpu")
        convert.load_mamba_params(m, params)
    return m


def _export(kind, params):
    if kind == "mstcn":
        return convert.export_mstcn_state_dict(params, MSTCN["stages"], MSTCN["layers"])
    return convert.export_mamba_state_dict(params, MAMBA["layers"])


def _assert_state_close(model, want_sd, atol):
    got = model.state_dict()
    assert sorted(got) == sorted(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=atol, err_msg=k)


# -- losses --------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    S, B, T = 2, 2, 21
    out = rng.standard_normal((S, B, T, 14)).astype(np.float32)
    labels = rng.integers(0, 7, (B, T)).astype(np.int32)
    ant = rng.uniform(0, 1, (B, T, 7)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 15:] = False
    w = np.asarray(TrainConfig().class_weights, np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    for m in (None, mask):
        jm = None if m is None else j(m)
        want = jax_losses.temporal_stage_loss(j(out), j(labels), j(ant), j(w), jm)
        got = losses.temporal_stage_loss(t(out), t(labels), t(ant), t(w),
                                         None if m is None else t(m))
        np.testing.assert_allclose([g.item() for g in got], np.asarray(want), rtol=0, atol=1e-6)
        want = jax_losses.refiner_loss(j(out[0]), j(labels), j(ant), j(w), jm)
        got = losses.refiner_loss(t(out[0]), t(labels), t(ant), t(w),
                                  None if m is None else t(m))
        np.testing.assert_allclose([g.item() for g in got], np.asarray(want), rtol=0, atol=1e-6)


# -- dropout -------------------------------------------------------------------------

def test_dropout_is_flax_dropout_from_its_mask():
    """flax keeps with probability 1 - p and divides the kept values by 1 - p:
    the port gives the same bits from flax's mask; eval mode is the identity;
    a step's masks follow (seed, epoch, batch)."""
    x = np.random.default_rng(2).standard_normal((2, 9, 5)).astype(np.float32)
    rate = 0.3
    want = np.asarray(fnn.Dropout(rate).apply({}, x, deterministic=False,
                                              rngs={"dropout": jax.random.key(4)}))
    mask = torch.from_numpy(want != 0)
    got = dropout(torch.from_numpy(x), rate, True, DropoutMasks(masks=[mask]))
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(dropout(torch.from_numpy(x), rate, False, None),
                               torch.from_numpy(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a DropoutMasks"):
        dropout(torch.from_numpy(x), rate, True, None)
    draw = lambda *c: dropout_masks(*c, device="cpu").keep((4, 50, 8), rate, "cpu")
    assert torch.equal(draw(1, 2, 3), draw(1, 2, 3))
    assert not torch.equal(draw(1, 2, 3), draw(1, 2, 4))
    assert not torch.equal(draw(1, 2, 3), draw(1, 3, 3))
    keep = draw(5, 0, 0).float().mean().item()
    assert abs(keep - (1 - rate)) < 0.03


def _flax_masks(model, params, x, key):
    """Model output in train mode and the keep-mask of every flax Dropout
    call, in call order (recorded while tracing, returned by the jitted
    apply)."""
    def run(params, x):
        masks = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                masks.append(out != 0)
            return out

        with fnn.intercept_methods(record):
            out = model.apply({"params": params}, x, deterministic=False, rngs={"dropout": key})
        return out, masks

    out, masks = jax.jit(run)(params, x)
    return np.asarray(out), [torch.from_numpy(np.asarray(m)) for m in masks]


@pytest.mark.parametrize("kind, atol", [("mstcn", 1e-5), ("mamba", 1e-4)])
def test_train_mode_under_flax_masks_matches_jax(kind, atol):
    """Train-mode outputs with flax's masks injected: the port drops at the
    same places and in the same call order (after conv_1x1 in each layer;
    after each Mamba block). JAX's Mamba takes its sequential reference scan
    here, which compiles faster than its associative one."""
    jm = _jax_model(kind, 0.5, backend="ref")
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8, F_DIM)))["params"]
    x = np.random.default_rng(3).standard_normal((2, 40, F_DIM)).astype(np.float32)
    want, masks = _flax_masks(jm, params, x, jax.random.key(9))
    assert len(masks) == (MSTCN["stages"] * MSTCN["layers"] if kind == "mstcn"
                          else MAMBA["layers"])
    model = _port_model(kind, jax.tree.map(np.asarray, params), 0.5).train()
    got = model(torch.from_numpy(x), masks=DropoutMasks(masks=masks))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)


# -- one temporal step ---------------------------------------------------------------

def _temporal_pair(kind, cfg):
    jt = JaxTemporalTrainer(_jax_model(kind), cfg)
    params, opt_state = jt.init(jax.random.key(0), F_DIM)
    params = jax.tree.map(np.asarray, params)
    model = _port_model(kind, params)
    return jt, params, opt_state, model, TemporalTrainer(model, _port_cfg(cfg))


def _port_cfg(cfg):
    """The port's TrainConfig with the JAX one's values."""
    return port_config.TrainConfig(bucket_sizes=cfg.bucket_sizes,
                                   optim=port_config.OptimConfig(**dataclasses.asdict(cfg.optim)))


@pytest.mark.parametrize("kind, lengths, atol", [
    ("mstcn", [64], EXACT), ("mamba", [64], EXACT),
    ("mstcn", [20, 30], EXACT), ("mamba", [20, 30], PADDED_MAMBA)],
    ids=["mstcn-at-bucket", "mamba-at-bucket", "mstcn-padded-pair", "mamba-padded-pair"])
def test_temporal_step_matches_jax(kind, lengths, atol):
    """One AdamW step at dropout 0: a video whose length is its bucket (both
    sides at length 64), and a batch of two videos padded to bucket 32 with
    their mask (both sides padded)."""
    cfg = TrainConfig(bucket_sizes=BUCKETS, optim=OptimConfig(lr=1e-3))
    jt, params, opt_state, model, trainer = _temporal_pair(kind, cfg)
    ds = _ds(lengths, seed=len(lengths))
    [(bucket, vids)] = make_batches(ds, range(ds.num_videos), len(lengths), BUCKETS)
    feats, labels, ant, mask = jt._collate(ds, bucket, vids)
    new_params, _, *jax_out = jt._train_step(params, opt_state, feats, labels, ant, mask,
                                             jax.random.key(1))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in collate(ds, bucket, vids)]
    assert [tuple(a.shape) for a in t] == [a.shape for a in (feats, labels, ant, mask)]
    opt = trainer.init()
    port_out = trainer.train_step(opt, t[0], t[1].long(), t[2], t[3], DropoutMasks())
    np.testing.assert_allclose([float(v) for v in port_out[:3]],
                               [float(v) for v in jax_out[:3]], rtol=0, atol=atol)
    assert int(port_out[3]) == int(jax_out[3])
    _assert_state_close(model, _export(kind, jax.tree.map(np.asarray, new_params)), atol)


def test_epoch_follows_jax_batch_order():
    """Four videos in two buckets (32, 64, 32, 64 frames: each at its bucket)
    run in JAX's order (0, 2, 1, 3 unshuffled), shuffled or not; a whole
    shuffled epoch of MS-TCN steps ends at JAX's parameters and metrics."""
    lengths = [32, 64, 32, 64]
    ds = _ds(lengths, seed=5)
    cfg = TrainConfig(bucket_sizes=BUCKETS, optim=OptimConfig(lr=1e-3))
    jt, params, opt_state, model, trainer = _temporal_pair("mstcn", cfg)
    assert make_batches(ds, range(4), 1, BUCKETS) == jt._make_batches(ds, range(4), 1)
    assert [v for _, v in make_batches(ds, range(4), 1, BUCKETS)] == [[0], [2], [1], [3]]
    for epoch in (0, 3):
        order = list(range(4))
        jax_rng.host_rng(jax.random.key(11), epoch).shuffle(order)
        port_order = list(range(4))
        port_rng.host_rng(11, epoch).shuffle(port_order)
        assert port_order == order
        assert make_batches(ds, order, 2, BUCKETS) == jt._make_batches(ds, order, 2)
    new_params, _, jm = jt.train_epoch(params, opt_state, ds, jax.random.key(1), 0,
                                       shuffle=True)
    pm = trainer.train_epoch(trainer.init(), ds, 1, 0, shuffle=True)
    assert sorted(pm) == sorted(jm)
    for k in ("train_loss", "train_loss_phase", "train_loss_ant", "train_acc"):
        assert abs(pm[k] - jm[k]) <= 4 * EXACT, k
    _assert_state_close(model, _export("mstcn", jax.tree.map(np.asarray, new_params)), EXACT)
    jev, jpreds = jt.evaluate(new_params, ds)
    pev, ppreds = trainer.evaluate(ds)
    assert sorted(pev) == sorted(jev)
    assert all(np.array_equal(a, b) for a, b in zip(ppreds, jpreds))


def test_plateau_and_lr_follow_jax():
    """ReduceLROnPlateau through the trainers: the same metric sequence gives
    the same lr sequence (JAX keeps its lr in float32)."""
    cfg = TrainConfig(bucket_sizes=BUCKETS, optim=OptimConfig(lr=1e-3, plateau_patience=1))
    jt, params, opt_state, model, trainer = _temporal_pair("mstcn", cfg)
    opt = trainer.init()
    for metric in (0.5, 0.6, 0.6, 0.55, 0.58, 0.7, 0.7, 0.7):
        opt_state, jlr = jt.plateau_step(opt_state, metric)
        lr = trainer.plateau_step(opt, metric)
        assert lr == pytest.approx(jlr, rel=1e-6)
        assert opt.param_groups[0]["lr"] == lr
        assert (trainer.plateau.best, trainer.plateau.bad_epochs) == (jt.plateau.best,
                                                                      jt.plateau.bad_epochs)
    assert lr == pytest.approx(2.5e-4)


# -- one refiner step ----------------------------------------------------------------

def _reference_slots_only(tree):
    """JAX's refiner also holds LayerNorm affines and FFN biases, which the
    reference's layout (and the port's) has not: its LayerNorms are inline and
    its FFN has no bias. JAX's optimizer moves them from identity and zero
    (a known difference); the exporter takes them at those values."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _reference_slots_only(v) for k, v in tree.items()}
    if "ln" in out:
        out["ln"] = {"scale": np.ones_like(out["ln"]["scale"]),
                     "bias": np.zeros_like(out["ln"]["bias"])}
    for k in ("fc1", "fc2"):
        if k in out and "bias" in out[k]:
            out[k] = {**out[k], "bias": np.zeros_like(out[k]["bias"])}
    return out


def test_refiner_step_matches_jax():
    """One Adam step of the refiner on a 64-frame video (its bucket) over the
    frozen MS-TCN: loss, its parts, correct frames and every parameter of the
    reference layout; the temporal parameters do not move."""
    cfg = TrainConfig(bucket_sizes=BUCKETS,
                      optim=OptimConfig(name="adam", lr=5e-4, weight_decay=0.0))
    jtemporal = _jax_model("mstcn")
    tparams = jax.tree.map(np.asarray, jtemporal.init(jax.random.key(0),
                                                      jnp.zeros((1, 8, F_DIM)))["params"])
    jr = JaxRefinerTrainer(jtemporal, JaxRefiner(RefinerConfig(**REFINER)), cfg)
    rparams, ropt = jr.init(jax.random.key(1), tparams, F_DIM)
    rparams = jax.tree.map(np.asarray, rparams)
    temporal = _port_model("mstcn", tparams)
    refiner = RefinementTransformer(port_config.RefinerConfig(**REFINER), device="cpu")
    convert.load_refiner_params(refiner, rparams)
    before = {k: v.clone() for k, v in temporal.state_dict().items()}
    ds = _ds([64], seed=8)
    f, l, a = ds.video_arrays(0)
    new_rparams, _, *jax_out = jr._train_step(tparams, rparams, ropt, f, l, a,
                                              np.ones(64, bool))
    trainer = RefinerTrainer(temporal, refiner, _port_cfg(cfg))
    port_out = trainer.train_step(trainer.init(), torch.from_numpy(f), torch.from_numpy(l).long(),
                                  torch.from_numpy(a))
    np.testing.assert_allclose([float(v) for v in port_out[:3]],
                               [float(v) for v in jax_out[:3]], rtol=0, atol=EXACT)
    assert int(port_out[3]) == int(jax_out[3])
    new_rparams = _reference_slots_only(jax.tree.map(np.asarray, new_rparams))
    want = convert.export_refiner_state_dict(new_rparams, REFINER.get("n_layers", 1))
    _assert_state_close(refiner, want, EXACT)
    assert all(torch.equal(v, before[k]) for k, v in temporal.state_dict().items())


# -- the verbs -----------------------------------------------------------------------

def _work(root, seed=0):
    """A work dir with index/ and lfb/ for train (videos of 40, 64, 50
    frames), val (48) and test (56, 30), Cholec80 label rows."""
    rng = np.random.default_rng(seed)
    for split, lengths, ids in (("train", (40, 64, 50), (1, 2, 3)), ("val", (48,), (41,)),
                                ("test", (56, 30), (42, 43))):
        n = sum(lengths)
        phase = np.concatenate([np.sort(rng.integers(0, 7, L)) for L in lengths])
        labels = np.concatenate([phase[:, None], rng.integers(0, 2, (n, 7)),
                                 rng.uniform(0, 1, (n, 7))], 1).astype(np.float32)
        idx = os.path.join(root, "index")
        os.makedirs(idx, exist_ok=True)
        np.save(os.path.join(idx, f"{split}_labels.npy"), labels)
        np.save(os.path.join(idx, f"{split}_num_each.npy"), np.asarray(lengths))
        np.save(os.path.join(idx, f"{split}_video_ids.npy"), np.asarray(ids, np.int64))
        feats = (rng.standard_normal((n, F_DIM)) * 0.1 + phase[:, None]).astype(np.float32)
        FeatureStore.create(os.path.join(root, "lfb", split), feats, lengths)
    return root


def _store_bits(directory):
    """Every step's weights, optimizer state and manifest of a store."""
    store = CheckpointStore(directory)
    out = {}
    for step in store.steps():
        sd = torch.load(store._path(step, ".pt"), weights_only=True)
        aux = store.restore_aux(step)["optimizer"]
        state = {(i, k): v for i, s in aux["state"].items() for k, v in s.items()}
        man = store.manifest(step)
        man["metrics"] = {k: v for k, v in man["metrics"].items() if k != "train_train_time_s"}
        out[step] = (sd, state, aux["param_groups"], man)
    return out


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for step in a:
        (sd, state, groups, man), (sd2, state2, groups2, man2) = a[step], b[step]
        assert all(torch.equal(sd[k], sd2[k]) for k in sd) and sorted(sd) == sorted(sd2)
        assert sorted(state) == sorted(state2)
        assert all(torch.equal(torch.as_tensor(state[k]), torch.as_tensor(state2[k]))
                   for k in state)
        assert groups == groups2 and man == man2


@pytest.mark.parametrize("kind", ["mstcn", "mamba"])
def test_cli_train_resume_equals_uninterrupted(kind, tmp_path):
    """train-temporal 1 epoch + --resume to 2, and train-refiner the same,
    equal the 2-epoch runs bit for bit (weights, optimizer state with its lr,
    manifests with the plateau state); the checkpoints feed predict."""
    works = [_work(str(tmp_path / name)) for name in ("resumed", "straight")]
    base = ["--model", kind, "--device", "cpu", "--lr", "1e-4"]
    for verb in ("train-temporal", "train-refiner"):
        w = works[0]
        assert cli.main([verb, "--work", w, *base, "--epochs", "1"]) == 0
        assert cli.main([verb, "--work", w, *base, "--epochs", "2", "--resume"]) == 0
        assert cli.main([verb, "--work", works[1], *base, "--epochs", "2"]) == 0
        sub = "temporal" if verb == "train-temporal" else "refiner"
        got, want = (_store_bits(os.path.join(w, "ckpt", sub)) for w in works)
        _assert_same_bits(got, want)
        man = CheckpointStore(os.path.join(works[0], "ckpt", sub)).manifest(1)
        if sub == "temporal":
            keys = {"val_acc", "test_acc", "val_inMAE", "lr", "train_train_loss"}
            assert keys <= set(man["metrics"])
            assert set(man["extra"]["plateau"]) == {"best", "bad_epochs"}
    assert cli.main(["predict", "--work", works[0], "--split", "test", "--model", kind,
                     "--device", "cpu"]) == 0
    assert sorted(os.listdir(os.path.join(works[0], "output", "Test"))) == [
        "video42-phase.txt", "video43-phase.txt"]


def test_cli_selfcheck(capsys):
    assert cli.main(["selfcheck", "--device", "cpu"]) == 0
    assert "SELFCHECK OK" in capsys.readouterr().out
    # selfcheck --full runs the whole pipeline: tests/test_torch_selfcheck_full.py


def test_chip_smoke_temporal_train_phase_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's temporal-training phase at full width, sized down to
    short videos and two epochs on the CPU: the same verbs, resume check,
    predict and selfcheck as on the card (the learned gate needs the card's
    epochs and is off here; the kernels' launch counts are 0 on the CPU)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "TT_TRAIN", (24, 40, 32))
    monkeypatch.setattr(chip_smoke, "TT_VAL", (30,))
    monkeypatch.setattr(chip_smoke, "TT_TEST", (20, 36))
    monkeypatch.setattr(chip_smoke, "TT_RECIPES", {"mamba": (2, 1e-4, 1, 1e-3),
                                                   "mstcn": (2, 1e-3, 1, 1e-3)})
    monkeypatch.setattr(chip_smoke, "GATE", 0.0)
    res = chip_smoke.phase_temporal_train(str(tmp_path), device="cpu")
    for kind in ("mamba", "mstcn"):
        assert res[kind]["resume_bitwise"] and res[kind]["resume_max_abs"] == 0.0
    assert {"train-temporal mamba", "train-refiner mstcn", "selfcheck"} <= set(res["seconds"])
