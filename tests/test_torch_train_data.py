"""The port's training-data layer, losses and optimizers against the JAX
package's, on seeded numpy inputs (CPU).

Stated bounds: geometry (crop, flip, rotation, sampling, frame caches, PIL
decode) exact; colour jitter within 1e-6 in [0, 1] units (fp32 on both
sides, summation orders differ), which Normalize scales by 1 / std to
COLOUR_ATOL; losses at rtol 1e-6; five optimizer steps against optax at
1e-6.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surgical_tpu.core.config import CHOLEC80_STD
from surgical_tpu.core.config import OptimConfig as JaxOptimConfig
from surgical_tpu.data import datasets as jds
from surgical_tpu.data import transforms as jtf
from surgical_tpu.train import losses as jlosses
from surgical_tpu.train import optim as joptim
from surgical_tpu_torch.core import rng as rnglib
from surgical_tpu_torch.core.config import OptimConfig
from surgical_tpu_torch.data import datasets as pds
from surgical_tpu_torch.data import transforms as ptf
from surgical_tpu_torch.train import losses as plosses
from surgical_tpu_torch.train import optim as poptim
from surgical_tpu_torch.utils.logging import MetricsLogger

CFG = jtf.AugConfig(resize=40, crop=32, degrees=5.0)
PCFG = ptf.AugConfig(resize=40, crop=32, degrees=5.0)
B = 6
COLOUR_ATOL = 1e-6 / min(CHOLEC80_STD)  # 1e-6 before Normalize


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    jax.config.update("jax_default_matmul_precision", "highest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (B, 40, 40, 3)).astype(np.float32)
    seg = rng.uniform(0, 1, (B, 40, 40, 3)).astype(np.float32)
    flow = rng.standard_normal((B, 40, 40, 2)).astype(np.float32)
    return img, seg, flow


def _jax_params(key, cfg=CFG, n=B):
    """The per-image parameters JAX's train_preprocess_batch draws."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    return jax.vmap(lambda k: jtf.draw_params(k, cfg))(keys)


def _port_params(jp):
    return ptf.AugParams(*(_t(np.asarray(f)) for f in jp))


# -- augmentation ---------------------------------------------------------------

def test_train_preprocess_batch_matches_jax_with_injected_params():
    img, seg, flow = _batch()
    key = jax.random.key(3)
    jp = _jax_params(key)
    assert np.asarray(jp.flip).any() and not np.asarray(jp.flip).all()
    assert len(set(np.asarray(jp.angle_deg).tolist())) > 2
    want = jtf.train_preprocess_batch(jnp.asarray(img), jnp.asarray(seg), jnp.asarray(flow),
                                      key, CFG)
    got = ptf.train_preprocess_batch(_t(img), _t(seg), _t(flow), cfg=PCFG,
                                     params=_port_params(jp))
    for name, g, w in zip(("images", "segmaps", "flow"), got, want):
        assert g.shape == (B, 32, 32, w.shape[-1]) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=COLOUR_ATOL,
                                   err_msg=name)


def test_geometry_is_exact():
    """Crop, flip (u negated) and the table rotation move values without
    arithmetic: integer-valued inputs come out bit-identical to JAX's."""
    rng = np.random.default_rng(1)
    x = rng.integers(-1000, 1000, (B, 40, 40, 2)).astype(np.float32)
    jp = _jax_params(jax.random.key(5))
    pp = _port_params(jp)
    crop = lambda a, xy: jtf.crop(a[None], xy, CFG.crop)[0]
    want = jax.vmap(crop)(jnp.asarray(x), jp.crop_xy)
    want = jax.vmap(lambda a, f: jtf.hflip(a[None], f, negate_u=True)[0])(want, jp.flip)
    idx = (jp.angle_deg.astype(jnp.int32) + 5).astype(jnp.int32)
    want = jtf.batched_rotate_nearest(want, idx, 5)
    got = ptf.crop(_t(x), pp.crop_xy, PCFG.crop)
    got = ptf.hflip(got, pp.flip, negate_u=True)
    got = ptf.batched_rotate_nearest(got, pp.angle_deg.long() + 5, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ptf._rotation_tables(32, 5), jtf._rotation_tables(32, 5))


def test_train_preprocess_batch_bf16_keeps_dtype_and_rotates_flow_at_its_own():
    """bf16 images stay bf16; fp32 flow is rotated in fp32 (the JAX package
    would round it to the image dtype first: ROADMAP Queue 3)."""
    img, seg, flow = _batch(2)
    jp = _jax_params(jax.random.key(4))
    got = ptf.train_preprocess_batch(_t(img).bfloat16(), _t(seg).bfloat16(), _t(flow), cfg=PCFG,
                                     params=_port_params(jp))
    assert (got[0].dtype, got[1].dtype, got[2].dtype) == (torch.bfloat16,) * 2 + (torch.float32,)
    ref = ptf.train_preprocess_batch(_t(img), _t(seg), _t(flow), cfg=PCFG, params=_port_params(jp))
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)


def test_draw_params_from_a_generator():
    g1 = rnglib.generator(42, 1, 7, purpose="augment")
    g2 = rnglib.generator(42, 1, 7, purpose="augment")
    p1, p2 = ptf.draw_params(g1, PCFG, 64), ptf.draw_params(g2, PCFG, 64)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert p1.crop_xy.min() >= 0 and p1.crop_xy.max() <= PCFG.resize - PCFG.crop
    assert set(p1.angle_deg.tolist()) <= set(range(-5, 6))
    assert 0.9 <= p1.brightness.min() and p1.brightness.max() <= 1.1
    assert -0.05 <= p1.hue.min() and p1.hue.max() <= 0.05
    p3 = ptf.draw_params(rnglib.generator(42, 1, 8, purpose="augment"), PCFG, 64)
    assert not torch.equal(p1.brightness, p3.brightness)
    with pytest.raises(ValueError, match="wire size"):
        ptf.train_preprocess_batch(torch.zeros(1, 30, 30, 3), torch.zeros(1, 30, 30, 3), None,
                                   g1, PCFG)


def test_eval_preprocess_matches_jax():
    img, seg, flow = _batch(3)
    want = jtf.eval_preprocess_clip(jnp.asarray(img), jnp.asarray(seg), jnp.asarray(flow), CFG)
    got = ptf.eval_preprocess_clip(_t(img), _t(seg), _t(flow), PCFG)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=COLOUR_ATOL)


# -- losses -------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 9, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, (5, 9))
    mask = rng.uniform(size=(5, 9)) > 0.3
    w = rng.uniform(0.2, 2.0, 7).astype(np.float32)
    pred = rng.standard_normal((5, 9, 7)).astype(np.float32) * 2
    target = rng.standard_normal((5, 9, 7)).astype(np.float32)
    J, P = jnp.asarray, _t
    cases = [
        (jlosses.weighted_cross_entropy(J(logits), J(labels), J(w), J(mask)),
         plosses.weighted_cross_entropy(P(logits), P(labels), P(w), P(mask))),
        (jlosses.weighted_cross_entropy(J(logits), J(labels), reduction="sum"),
         plosses.weighted_cross_entropy(P(logits), P(labels), reduction="sum")),
        (jlosses.smooth_l1(J(pred), J(target)), plosses.smooth_l1(P(pred), P(target))),
        (jlosses.smooth_l1(J(pred), J(target), mask=J(mask), reduction="sum"),
         plosses.smooth_l1(P(pred), P(target), mask=P(mask), reduction="sum")),
        (jlosses.smooth_l1(J(pred), J(target), mask=J(mask)),
         plosses.smooth_l1(P(pred), P(target), mask=P(mask))),
    ]
    jb = jlosses.backbone_loss(J(logits[0]), J(pred[0]), J(labels[0]), J(target[0]))
    pb = plosses.backbone_loss(P(logits[0]), P(pred[0]), P(labels[0]), P(target[0]))
    for want, got in cases + list(zip(jb, pb)):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -- optimizers ---------------------------------------------------------------------

@pytest.mark.parametrize("name,clip", [("sgd", None), ("adam", None), ("adamw", None),
                                       ("adamw", 0.5)])
def test_optimizer_matches_optax(name, clip):
    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(5)]
    kw = dict(name=name, lr=3e-2, weight_decay=1e-2, grad_clip_norm=clip)
    tx = joptim.build_optimizer(JaxOptimConfig(**kw))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = poptim.build_optimizer(OptimConfig(**kw), params)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = _t(x)
        opt.step()
    for p, want in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert poptim.get_lr(opt) == pytest.approx(joptim.get_lr(state)) == pytest.approx(3e-2)
    poptim.set_lr(opt, 1e-3)
    assert poptim.get_lr(opt) == pytest.approx(joptim.get_lr(joptim.set_lr(state, 1e-3)))


def test_plateau_controller_matches_jax():
    metrics = [0.5, 0.6, 0.6, 0.55, 0.58, 0.59, 0.61, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    for mode in ("max", "min"):
        j, p = joptim.PlateauController(mode=mode, patience=2), poptim.PlateauController(
            mode=mode, patience=2)
        lj = lp = 1e-3
        for m in metrics:
            lj, lp = j.step(m, lj), p.step(m, lp)
            assert lj == lp and j.bad_epochs == p.bad_epochs


# -- sampling, caches, decode ---------------------------------------------------------

def test_clip_sampling_matches_jax():
    lengths = [7, 3, 12, 1]
    for seq in (1, 3):
        starts = pds.clip_start_indices(seq, lengths)
        assert starts == jds.clip_start_indices(seq, lengths)
        js, ps = jds.ClipSampler(seq, starts, seed=9), pds.ClipSampler(seq, starts, seed=9)
        for epoch in (0, 1, 2):
            np.testing.assert_array_equal(ps.indices(epoch, shuffle=True),
                                          js.indices(epoch, shuffle=True))
        np.testing.assert_array_equal(ps.indices(), js.indices())


class _Frames:
    """An in-memory frame source in the wire format."""

    resize, with_flow, ant_cols = 16, True, (8, 15)

    def __init__(self, n=11):
        rng = np.random.default_rng(6)
        self.img = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
        self.seg = rng.integers(0, 256, (n, 16, 16, 1), dtype=np.uint8)
        self.flow = rng.standard_normal((n, 16, 16, 2)).astype(np.float16)
        self.labels = np.concatenate([rng.integers(0, 7, (n, 1)), rng.integers(0, 2, (n, 7)),
                                      rng.uniform(0, 1, (n, 7))], 1).astype(np.float32)

    def __len__(self):
        return len(self.img)

    def frames(self, idx):
        idx = np.asarray(idx)
        return (self.img[idx], self.seg[idx], self.flow[idx], self.labels[idx, 0].astype(np.int32),
                self.labels[idx, 8:15])


def test_frame_cache_matches_jax(tmp_path):
    src = _Frames()
    pc = pds.FrameCache.build(src, str(tmp_path / "port"), batch_size=4)
    jc = jds.FrameCache.build(src, str(tmp_path / "jax"), batch_size=4)
    cross = pds.FrameCache(str(tmp_path / "jax"))  # the port reads the JAX cache
    assert len(pc) == len(jc) == len(cross) == len(src)
    idx = np.array([3, 0, 10, 7])
    for got, other, want in zip(pc.frames(idx), cross.frames(idx), jc.frames(idx)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(other, want)
    batches = list(pds.prefetch_batches(pc, np.arange(11), 4, num_workers=2, depth=2))
    assert [b[0].shape[0] for b in batches] == [4, 4, 3]
    np.testing.assert_array_equal(np.concatenate([b[2] for b in batches]), src.flow)


def test_clip_dataset_decodes_like_jax(tmp_path):
    """PIL decode + resize of images, segmaps and flow .npy (resized with
    displacement rescale), against the JAX ClipDataset with its native
    decoder off."""
    from PIL import Image

    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        p = tmp_path / "cutMargin" / "1" / f"{i}.jpg"
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(p)
        s = tmp_path / "ss_Bimasks_pos_ep10" / "1" / f"{i}.png"
        s.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (20, 24), dtype=np.uint8)).save(s)
        if i != 1:  # frame 1 has no flow: zero flow
            f = tmp_path / "raft_flow_npy" / "1" / f"{i}.npy"
            f.parent.mkdir(parents=True, exist_ok=True)
            np.save(f, rng.standard_normal((10, 12, 2)).astype(np.float32))
        paths.append(str(p))
    labels = rng.uniform(0, 1, (3, 15)).astype(np.float32)
    got = pds.ClipDataset(paths, labels, resize=16).frames([2, 0, 1])
    want = jds.ClipDataset(paths, labels, resize=16, use_native=False).frames([2, 0, 1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3, 16, 16, 3) and got[1].shape == (3, 16, 16, 1)
    assert not got[2][2].any() and got[2][0].any()


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), tensorboard=False)
    log.log(3, {"loss": np.float32(1.5), "note": "x"}, prefix="val/")
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["val/loss"] == 1.5 and rec["val/note"] == "x"


def test_training_modules_import_no_jax():
    """Importing the port's training modules loads neither JAX nor the JAX
    package (the run-time check chip_smoke.py makes, here per module)."""
    mods = ["surgical_tpu_torch.train.backbone", "surgical_tpu_torch.train.optim",
            "surgical_tpu_torch.train.losses", "surgical_tpu_torch.data.transforms",
            "surgical_tpu_torch.data.datasets", "surgical_tpu_torch.models.mit_train",
            "surgical_tpu_torch.core.rng", "surgical_tpu_torch.utils.logging",
            "surgical_tpu_torch.cli"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'surgical_tpu'))\nprint(bad)\nassert not bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
