"""The configurations the JAX package's kernels take beyond MiT-b3 at 224
px and d_state 128, on the CPU: the train block at head width 32 and at 81
keys per head, the serving block, its hb form and the stage at 81 and 144
keys per head, the b0 serving graph with more than 64 keys per head at
stage 1, and the selective scan at d_state 192 and 256, each against the
JAX package with its Pallas kernels in interpret mode (the port's kernel
wrappers run their plain versions on CPU tensors); the scan's sliced
layout (one forward launch per slice of at most 128 states, one backward
launch per 64-wide slice) through the plain versions; and the launch plans
of the attention kernels past 64 keys. The kernels themselves are held to
their plain versions on the card by ``tests/test_torch_limits_card.py``,
which imports no JAX.

Stated bounds: the train block 1e-5 (rtol and atol; fp32, summation order
only, as tests/test_torch_train_kernel.py); the serving block and stage
1e-4 (tests/test_torch_mit_block.py's); the b0 graph correlation > 0.999
and median relative error < 2e-2 over the pooled features
(tests/test_torch_widths.py's: both sides bf16); the scan 1e-5 max abs;
the sliced layouts 1e-5 of the largest value or gradient (fp32, zero terms
added in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.kernels import mit_block as jmb
from surgical_tpu.kernels.selective_scan import selective_scan_pallas
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import selective_scan as ss
from surgical_tpu_torch.models.mit_fused import fused_forward
from test_torch_mit_graph import jax_variables, port_model
from test_torch_packed2 import jax_fused_interpret_cfg
from test_torch_widths import _plain_states, _scan_inputs

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

TRAIN_TOL, SERVE_TOL = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-4)
ATOL_SCAN, REL_SLICE = 1e-5, 1e-5
B, H, W = 2, 4, 6
N = H * W


def _weights(rng, C, hidden, lead=()):
    """Block weights in the JAX layout (the port's too), fp32."""
    r = lambda *s, scale=1.0, offset=0.0: (offset + scale * rng.standard_normal(lead + s)).astype(
        np.float32)
    return {
        "wq": r(C, C, scale=C ** -0.5), "bq": r(C, scale=0.1),
        "wo": r(C, C, scale=C ** -0.5), "bo": r(C, scale=0.1),
        "ln1_scale": r(C, scale=0.1, offset=1.0), "ln1_bias": r(C, scale=0.1),
        "ln2_scale": r(C, scale=0.1, offset=1.0), "ln2_bias": r(C, scale=0.1),
        "w1": r(C, hidden, scale=C ** -0.5), "b1": r(hidden, scale=0.1),
        "wdw": r(9, hidden, scale=1 / 3), "bdw": r(hidden, scale=0.1),
        "w2": r(hidden, C, scale=hidden ** -0.5), "b2": r(C, scale=0.1),
    }


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# -- the train block at head width 32 and past 64 keys ----------------------------------

@pytest.mark.parametrize("C, heads, nkv", [(32, 1, 6), (64, 2, 6), (32, 1, 81), (64, 1, 81)])
def test_train_block_matches_jax(C, heads, nkv):
    """The port's ``fused_mit_block_train`` (its autograd function over the
    three wrappers, plain versions on the CPU) against JAX's
    ``fused_mit_block_train`` and ``jax.vjp`` (Pallas in interpret mode):
    y and the gradients of x, xln, k and v, with DropPath factors that hold
    both 0 and 1/keep."""
    rng = np.random.default_rng(C + nkv)
    w = _weights(rng, C, 2 * C)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, xln, k, v, dy = f(B, N, C), f(B, N, C), f(B, nkv, C), f(B, nkv, C), f(B, N, C)
    m1, m2 = np.array([0.0, 1.25], np.float32), np.array([1.25, 0.0], np.float32)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    fn = lambda x, xln, k, v: jmb.fused_mit_block_train(
        x, xln, k, v, jw, jnp.asarray(m1), jnp.asarray(m2), heads=heads, H=H, W=W,
        interpret=True)
    want_y, vjp = jax.vjp(fn, *map(jnp.asarray, (x, xln, k, v)))
    want_grads = vjp(jnp.asarray(dy))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, xln, k, v)]
    y = mb.fused_mit_block_train(*inputs, _t(w), torch.from_numpy(m1), torch.from_numpy(m2),
                                 heads=heads, H=H, W=W)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TRAIN_TOL)
    for name, got, want in zip(("x", "xln", "k", "v"), inputs, want_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), err_msg=name,
                                   **TRAIN_TOL)


# -- the serving block and stage past 64 keys --------------------------------------------

@pytest.mark.parametrize("variant", ["block", "block_hb"])
@pytest.mark.parametrize("C, heads, nkv", [(32, 1, 81), (64, 2, 81), (32, 2, 144),
                                           (64, 1, 144)])
def test_serving_block_matches_jax_past_64_keys(variant, C, heads, nkv):
    """The port's block (plain on the CPU) against JAX's ``fused_mit_block``
    and ``fused_mit_block_hb`` at head widths 32 and 64, 81 and 144 keys."""
    rng = np.random.default_rng(C * heads + nkv)
    w = _weights(rng, C, 4 * C)
    x, k, v = (rng.standard_normal((B, n, C)).astype(np.float32) for n in (N, nkv, nkv))
    jfn = jmb.fused_mit_block_hb if variant == "block_hb" else jmb.fused_mit_block
    want = jfn(x, None, k, v, w, heads=heads, H=H, W=W, interpret=True)
    got = mb.fused_mit_block(*map(torch.from_numpy, (x, k, v)), _t(w), heads=heads, H=H, W=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVE_TOL)


def _stage_weights(rng, C, depth, cb, c4):
    sw = _weights(rng, C, 4 * C, lead=(depth,))
    sw = {k: (a.reshape(depth, 1, -1) if a.ndim == 2 else a) for k, a in sw.items()}
    sw["ln1"] = np.stack([sw.pop("ln1_scale")[:, 0], sw.pop("ln1_bias")[:, 0]], 1)
    sw["ln2"] = np.stack([sw.pop("ln2_scale")[:, 0], sw.pop("ln2_bias")[:, 0]], 1)
    r = lambda *s, scale: (scale * rng.standard_normal(s)).astype(np.float32)
    sw.update(wkv=r(depth, C, 2 * C, scale=C ** -0.5), bkv=r(depth, 1, 2 * C, scale=0.1),
              lww=r(depth, cb, c4, scale=cb ** -0.5), lwb=r(depth, 1, c4, scale=0.1),
              sharedw=r(c4, C, scale=c4 ** -0.5), sharedb=r(1, C, scale=0.1))
    return sw


@pytest.mark.parametrize("C, heads, side", [(32, 1, 9), (64, 2, 9), (32, 2, 12), (64, 1, 12)])
def test_stage_matches_jax_past_64_keys(C, heads, side):
    """The port's stage (plain on the CPU, two blocks with the prompt in the
    stage, sr = 1 as at stage 4) against JAX's ``fused_mit_stage`` on grids
    of 9 x 9 and 12 x 12 tokens: 81 and 144 keys per head."""
    rng = np.random.default_rng(C + side)
    sw = _stage_weights(rng, C, 2, 8, 8)
    x = rng.standard_normal((B, side * side, C)).astype(np.float32)
    base = (0.5 * rng.standard_normal((B, side * side, 8))).astype(np.float32)
    want = jmb.fused_mit_stage(x, base, sw, heads=heads, H=side, W=side, sr=1, interpret=True)
    got = mb.fused_mit_stage(torch.from_numpy(x), torch.from_numpy(base), _t(sw), heads=heads,
                             H=side, W=side, sr=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVE_TOL)


def test_b0_serving_graph_past_64_keys_matches_jax():
    """The serving graph at b0 widths with SR ratios 1 / 1 / 1 / 1 on 64-px
    frames (256 keys per head at stage 1, 64 at stage 2) against JAX's
    fused_forward in interpret mode, on JAX weights carried from a seeded
    port model."""
    cfg = BackboneConfig.preset("b0", depths=(1, 1, 1, 1), drop_path_rate=0.0, img_size=64,
                                sr_ratios=(1, 1, 1, 1))
    head = HeadConfig(embedding_dim=64, hidden=32)
    variables = jax_variables(cfg, head, seed=6)
    rng = np.random.default_rng(6)
    img, seg, flow = (rng.standard_normal((2, 64, 64, c)).astype(np.float32) for c in (3, 3, 2))
    want = jax_fused_interpret_cfg(variables, img, seg, flow, cfg, head)
    got = fused_forward(port_model(cfg, head, variables), torch.from_numpy(img),
                        torch.from_numpy(seg), torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (2, head.embedding_dim) and np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    assert corr > 0.999, corr
    assert np.median(rel) < 2e-2, np.median(rel)


# -- the scan past 128 states ------------------------------------------------------------

@pytest.mark.parametrize("N, D", [(192, 8), (256, 4)])
def test_scan_matches_jax_pallas_past_128_states(N, D):
    """The port's scan (the plain version on the CPU) against JAX's Pallas
    scan in interpret mode, over two 64-step chunks and a ragged end."""
    x, dt, A, Bm, Cm, Dv, _ = _scan_inputs(1, 70, D, N, seed=N)
    want = np.asarray(selective_scan_pallas(x[0], dt[0], A, Bm[0], Cm[0], Dv, chunk=64,
                                            interpret=True))
    got = ss.selective_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm, Dv)))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=ATOL_SCAN)


@pytest.mark.parametrize("N, width, slices", [
    (129, 160, [(128, 128), (1, 32)]), (160, 160, [(128, 128), (32, 32)]),
    (192, 192, [(128, 128), (64, 64)]), (200, 256, [(128, 128), (72, 128)]),
    (256, 256, [(128, 128), (128, 128)]), (300, 320, [(128, 128), (128, 128), (44, 64)])])
def test_forward_slices_past_128_states(N, width, slices, monkeypatch):
    """``selective_scan_forward`` above 128 states, its launches replaced by
    the plain scan on the CPU: one launch per slice of at most 128 states at
    that slice's width (d_state, width), D in the first slice only, y the
    slices' sum and the states side by side at ``kernel_state(N)``, equal to
    the plain scan's and to the states of the zero-padded layout."""
    x, dt, A, Bm, Cm, Dv, _ = (torch.from_numpy(a) for a in _scan_inputs(2, 70, 6, N, seed=N))
    seen = []

    def launch(x, dt, A, B, C, D, states):
        n = A.shape[1]
        seen.append((n, ss.kernel_state(n), bool(D.abs().sum() > 0)))
        Ap, Bp, Cp = ss.pad_state(A, B, C, ss.kernel_state(n))
        return ss.selective_scan_plain(x, dt, A, B, C, D), _plain_states(x, dt, Ap, Bp, Cp)

    monkeypatch.setattr(ss, "_forward_launch", launch)
    y, states = ss.selective_scan_forward(x, dt, A, Bm, Cm, Dv, states=True)
    assert ss.kernel_state(N) == width
    assert seen == [(n, w, i == 0) for i, (n, w) in enumerate(slices)]
    want = ss.selective_scan_plain(x, dt, A, Bm, Cm, Dv)
    assert (y - want).abs().max() <= REL_SLICE * want.abs().max()
    assert tuple(states.shape) == ss.states_shape(2, 70, 6, width)
    Ap, Bp, Cp = ss.pad_state(A, Bm, Cm, width)
    torch.testing.assert_close(states, _plain_states(x, dt, Ap, Bp, Cp), rtol=0, atol=1e-5)


@pytest.mark.parametrize("N, D", [(160, 6), (192, 8), (200, 4), (256, 5)])
def test_backward_slices_past_128_states(N, D):
    """``padded_backward`` above 128 states through the plain backward: one
    launch per 64-wide slice of the padded state (a last slice of 32 at
    160), each at a width the backward is built for, on 4k channels and the
    forward's states of its own inputs; the six gradients equal the plain
    gradient of the unpadded scan within 1e-5 of the largest."""
    x, dt, A, Bm, Cm, Dv, dy = (torch.from_numpy(a) for a in _scan_inputs(2, 70, D, N, seed=N))
    width = ss.kernel_state(N)
    states = _plain_states(x, dt, *ss.pad_state(A, Bm, Cm, width))
    seen = []

    def launch(x, dt, A, B, C, D, dy, states):
        Bt, T, Dch = x.shape
        assert A.shape[1] in ss.BWD_STATE_WIDTHS and Dch % 4 == 0
        torch.testing.assert_close(states, _plain_states(x, dt, A, B, C), rtol=0, atol=0)
        seen.append((A.shape[1], bool(D.abs().sum() > 0)))
        return ss.selective_scan_plain_backward(x, dt, A, B, C, D, dy)

    got = ss.padded_backward(launch, x, dt, A, Bm, Cm, Dv, dy, states)
    want = ss.selective_scan_plain_backward(x, dt, A, Bm, Cm, Dv, dy)
    widths = [64] * (width // 64) + ([32] if width % 64 else [])
    assert [w for w, _ in seen] == widths
    assert [d for _, d in seen] == [True] + [False] * (len(widths) - 1)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= REL_SLICE * w.abs().max(), name


# -- the launch plans past 64 keys -------------------------------------------------------

# (C, heads, grid side, sr) of b0's and b3's stages at 288 / 320 / 384 / 512 px:
# 81 / 100 / 144 / 256 keys per head at every stage
STAGES = {"b0": ((32, 1, 8), (64, 2, 4), (160, 5, 2), (256, 8, 1)),
          "b3": ((64, 1, 8), (128, 2, 4), (320, 5, 2), (512, 8, 1))}
SIDES = {288: (72, 36, 18, 9), 320: (80, 40, 20, 10), 384: (96, 48, 24, 12),
         512: (128, 64, 32, 16)}


def _covers(rec, B, N, heads):
    tpc, gx, gy = rec
    qtiles = -(-N // mb.ATTN_ROWS)
    assert gy == B * heads and tpc >= 1 and (gx - 1) * tpc < qtiles <= gx * tpc


@pytest.mark.parametrize("px", sorted(SIDES))
@pytest.mark.parametrize("model", sorted(STAGES))
def test_plans_past_64_keys(model, px):
    """Every stage's forward plans (block, stage, train forward) and the
    attention backward's at B = 8, 88 and 200: the grids cover every (image,
    head, query tile) once, the backward's dq record covers them too and is
    zeros up to 64 keys, and every attention CTA's shared memory fits."""
    for (C, heads, sr), side in zip(STAGES[model], SIDES[px]):
        N, Nkv, hd = side * side, (side // sr) ** 2, C // heads
        assert Nkv == (px // 32) ** 2 > mb.MAX_KV
        fwd, (main, dq) = mb.attention_smem_bytes(hd, Nkv), mb.attn_backward_smem_bytes(hd, Nkv)
        assert fwd <= mb.STATIC_SMEM_LIMIT and 0 < dq and max(main, dq) <= mb.SMEM_LIMIT
        for B in (8, 88, 200):
            _covers(mb.attention_plan(B, N, heads, Nkv, hd), B, N, heads)
            _covers(mb.block_plan(B, side, side, C, heads, Nkv, 4 * C)[6:9], B, N, heads)
            _covers(mb.train_forward_plan(B, side, side, C, heads, Nkv, 4 * C)[6:9], B, N,
                    heads)
            plan = mb.attn_backward_plan(B, N, C, heads, Nkv)
            assert len(plan) == 3 * 6 + 6
            _covers(plan[18:21], B, N, heads)
            _covers(plan[21:24], B, N, heads)
            assert 1 <= plan[19] <= mb.ABW_MAX_SPLITS
        if sr == 1:
            _covers(mb.stage_plan(8, side, side, C, heads, 1, 4 * C, 64, 64)[30:33], 8, N, heads)


@pytest.mark.parametrize("C, heads", [(32, 1), (64, 2), (160, 5), (256, 8), (64, 1), (512, 8)])
def test_backward_plan_at_64_keys_keeps_one_tile(C, heads):
    """Up to 64 keys the backward runs its one-tile kernel: the dq record is
    zeros and the shared memory is the one-tile CTA's."""
    plan = mb.attn_backward_plan(88, 49 * 4, C, heads, 64)
    assert plan[21:24] == (0, 0, 0)
    assert mb.attn_backward_smem_bytes(C // heads, 64)[1] == 0


@pytest.mark.parametrize("call", [
    lambda: mb.attention_plan(8, 196, 5, 0),                  # no key
    lambda: mb.attn_backward_plan(8, 196, 320, 5, 0),         # no key
    lambda: mb.attn_backward_plan(8, 196, 320, 20, 81),       # head width 16
    lambda: mb.attn_backward_plan(8, 196, 48, 1, 81),         # head width 48
    lambda: mb.attention_plan(8192, 196, 8, 144, 64),         # more (image, head) pairs than a grid row
    lambda: mb.attn_backward_plan(8192, 196, 512, 8, 144),    # the same in the backward
    lambda: mb.attention_plan(8, 196, 1, 81, 128),            # head width 128: no CTA holds it
])
def test_limits_that_remain_raise(call):
    with pytest.raises(ValueError):
        call()
