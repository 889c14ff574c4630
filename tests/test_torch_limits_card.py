"""The kernels at the configurations of tests/test_torch_limits.py, held to
their plain versions on the card: the train kernels at head width 32 and
past 64 keys per head, the serving block and stage past 64 keys, and the
scan past 128 states. Every case is marked ``cuda`` and skips without a
card; the file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_limits_card.py -m cuda

Stated bounds: rel L2 per output as ``chip_smoke.py``'s (``BOUNDS`` for the
serving kernels by stage, ``TRAIN_BOUNDS`` for the train kernels, both
bf16 with the same rounding points, summation orders apart;
``SCAN_BOUNDS`` / ``SCAN_BWD_BOUNDS`` for the scan, fp32).
"""

import numpy as np
import pytest
import torch

from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import selective_scan as ss


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU build")


def _rand(rng, *shape, scale=1.0, offset=0.0):
    a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).cuda().bfloat16()


def _weights(rng, C, hidden):
    r = lambda *s, scale=1.0, offset=0.0: _rand(rng, *s, scale=scale, offset=offset)
    return {"wq": r(C, C, scale=C ** -0.5), "bq": r(C, scale=0.1),
            "wo": r(C, C, scale=C ** -0.5), "bo": r(C, scale=0.1),
            "ln1_scale": r(C, scale=0.1, offset=1.0), "ln1_bias": r(C, scale=0.1),
            "ln2_scale": r(C, scale=0.1, offset=1.0), "ln2_bias": r(C, scale=0.1),
            "w1": r(C, hidden, scale=C ** -0.5), "b1": r(hidden, scale=0.1),
            "wdw": r(9, hidden, scale=1 / 3), "bdw": r(hidden, scale=0.1),
            "w2": r(hidden, C, scale=hidden ** -0.5), "b2": r(C, scale=0.1)}


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("C, heads, side, sr, bound", [(32, 1, 72, 8, 1e-3), (64, 1, 96, 8, 1e-3),
                                                       (320, 5, 24, 2, 2e-3)])
def test_block_kernel_past_64_keys(C, heads, side, sr, bound):
    """The block kernel at 81 and 144 keys per head (b0's and b3's stage
    shapes at 288 and 384 px) against its plain version."""
    _needs_card()
    rng = np.random.default_rng(C + side)
    w = _weights(rng, C, 4 * C)
    N, Nkv = side * side, (side // sr) ** 2
    x, k, v = _rand(rng, 8, N, C), _rand(rng, 8, Nkv, C), _rand(rng, 8, Nkv, C)
    with torch.no_grad():
        got = mb.fused_mit_block(x, k, v, w, heads=heads, H=side, W=side)
        want = mb.fused_mit_block_plain(x, k, v, w, heads=heads, H=side, W=side)
    assert _rel(got, want) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("C, heads, side", [(256, 8, 9), (512, 8, 16)])
def test_stage_kernel_past_64_keys(C, heads, side):
    """The stage kernel at stage 4 (sr = 1, depth 2, the prompt in the
    stage) at 81 and 256 keys per head against its plain version."""
    _needs_card()
    rng = np.random.default_rng(C + side)
    w = _weights(rng, C, 4 * C)
    d = 2
    sw = {k: torch.stack([t] * d) for k, t in w.items()}
    sw = {k: (t.reshape(d, 1, -1) if t.dim() == 2 else t) for k, t in sw.items()}
    sw["ln1"] = torch.stack([sw.pop("ln1_scale")[:, 0], sw.pop("ln1_bias")[:, 0]], 1)
    sw["ln2"] = torch.stack([sw.pop("ln2_scale")[:, 0], sw.pop("ln2_bias")[:, 0]], 1)
    sw.update(wkv=_rand(rng, d, C, 2 * C, scale=C ** -0.5), bkv=_rand(rng, d, 1, 2 * C, scale=0.1),
              lww=_rand(rng, d, 64, 64, scale=0.125), lwb=_rand(rng, d, 1, 64, scale=0.1),
              sharedw=_rand(rng, 64, C, scale=0.125), sharedb=_rand(rng, 1, C, scale=0.1))
    sw = {k: t.contiguous() for k, t in sw.items()}
    x, base = _rand(rng, 8, side * side, C), _rand(rng, 8, side * side, 64)
    with torch.no_grad():
        got = mb.fused_mit_stage(x, base, sw, heads=heads, H=side, W=side, sr=1)
        want = mb.fused_mit_stage_plain(x, base, sw, heads=heads, H=side, W=side, sr=1)
    assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("C, heads, side, sr", [(32, 1, 56, 8), (160, 5, 14, 2),
                                                (32, 1, 72, 8), (160, 5, 24, 2),
                                                (512, 8, 16, 1)])
def test_train_kernels_at_head_width_32_and_past_64_keys(C, heads, side, sr):
    """The three train kernels at b0's stages 1 and 3 at 224 px (head width
    32, 49 keys), at 288 and 384 px (81 and 144 keys) and at b3's stage 4 at
    512 px (256 keys) against their plain versions: y, x1 and the backward's
    dx, dxln, dk, dv; the attention backward's outputs equal bit for bit
    over two runs."""
    _needs_card()
    bounds = {"y": 5e-3, "x1": 1e-3, "dx": 2e-3, "dxln": 1e-2, "dk": 1e-2, "dv": 1e-2}
    rng = np.random.default_rng(C + side)
    w = _weights(rng, C, 4 * C)
    B, N, Nkv = 8, side * side, (side // sr) ** 2
    kw = dict(heads=heads, H=side, W=side)
    x, xln, dy = _rand(rng, B, N, C), _rand(rng, B, N, C), _rand(rng, B, N, C)
    k, v = _rand(rng, B, Nkv, C), _rand(rng, B, Nkv, C)
    m1 = torch.tensor([0.0] + [1.25] * (B - 1), device="cuda")
    m2 = torch.tensor([1.25, 0.0] + [1.25] * (B - 2), device="cuda")
    with torch.no_grad():
        y, x1 = mb.block_train_forward(x, xln, k, v, w, m1, m2, **kw)
        got = mb._block_train_bwd(x1, xln, k, v, w, m1, m2, dy, **kw,
                                  mlp_bwd=mb.block_train_mlp_backward,
                                  attn_bwd=mb.block_train_attn_backward)
        want = (*mb.fused_mit_block_train_fwd_plain(x, xln, k, v, w, m1, m2, **kw),
                *mb.fused_mit_block_train_bwd_plain(x1, xln, k, v, w, m1, m2, dy, **kw))
        again = mb.block_train_attn_backward(xln, k, v, got[0], m1, w, heads=heads)
    for name, g, wnt in zip(bounds, (y, x1, *got), want):
        assert _rel(g, wnt) <= bounds[name], name
    for a, b in zip(got[1:], again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("N, D", [(192, 128), (256, 64)])
def test_scan_kernels_past_128_states(N, D):
    """The scan's forward (a launch per slice of at most 128 states) and
    backward (a launch per 64-wide slice) against the plain versions, fp32
    with TF32 off."""
    _needs_card()
    rng = np.random.default_rng(N + D)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    T = 300
    x, B, C, Dv, dy = f(1, T, D), f(1, T, N), f(1, T, N), f(D), f(1, T, D)
    dt = torch.nn.functional.softplus(f(1, T, D) - 2.0)
    A = -torch.exp(0.5 * f(D, N))
    ss.reset_launches()
    y, states = ss.selective_scan_forward(x, dt, A, B, C, Dv, states=True)
    assert ss.selective_scan.launches == len(ss.state_slices(N))
    assert _rel(y, ss.selective_scan_plain(x, dt, A, B, C, Dv)) <= 1e-6
    got = ss.selective_scan_backward(x, dt, A, B, C, Dv, dy, states)
    assert ss.selective_scan_backward.launches == ss.kernel_state(N) // 64
    for g, wnt in zip(got, ss.selective_scan_plain_backward(x, dt, A, B, C, Dv, dy)):
        assert g.shape == wnt.shape and _rel(g, wnt) <= 1e-4
