"""The port's training block (``fused_mit_block_train``: plain forward and
explicit plain backward) against the JAX package's ``fused_mit_block_train``
(Pallas kernels in interpret mode) and ``jax.vjp``, in fp32 on a non-square
grid, with DropPath factors that hold both 0 and 1/keep.

Stated bound: 1e-5 (rtol and atol) for every output and gradient. Both sides
compute in fp32 with the same operations; they differ by summation order
only (measured here: max abs error below 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.kernels.mit_block import fused_mit_block_train as jax_block_train
from surgical_tpu_torch.kernels import mit_block as mb

B, H, W, C, HEADS, NKV, HIDDEN = 2, 4, 6, 16, 2, 6, 32
N = H * W
KEEP = 0.8
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0, offset=0.0: (offset + scale * rng.standard_normal(s)).astype(
        np.float32)
    weights = {
        "wq": r(C, C, scale=C ** -0.5), "bq": r(C, scale=0.1),
        "wo": r(C, C, scale=C ** -0.5), "bo": r(C, scale=0.1),
        "ln1_scale": r(C, scale=0.1, offset=1.0), "ln1_bias": r(C, scale=0.1),
        "ln2_scale": r(C, scale=0.1, offset=1.0), "ln2_bias": r(C, scale=0.1),
        "w1": r(C, HIDDEN, scale=C ** -0.5), "b1": r(HIDDEN, scale=0.1),
        "wdw": r(9, HIDDEN, scale=1 / 3), "bdw": r(HIDDEN, scale=0.1),
        "w2": r(HIDDEN, C, scale=HIDDEN ** -0.5), "b2": r(C, scale=0.1),
    }
    x, xln = r(B, N, C), r(B, N, C)
    k, v = r(B, NKV, C), r(B, NKV, C)
    m1 = np.array([0.0, 1 / KEEP], np.float32)  # image 0's attention branch dropped
    m2 = np.array([1 / KEEP, 0.0], np.float32)  # image 1's MLP branch dropped
    dy = r(B, N, C)
    return weights, (x, xln, k, v, m1, m2), dy


def _torch(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def jax_reference():
    jax.config.update("jax_default_matmul_precision", "highest")
    weights, (x, xln, k, v, m1, m2), dy = _inputs()
    jw = {n: jnp.asarray(a) for n, a in weights.items()}
    fn = lambda x, xln, k, v: jax_block_train(x, xln, k, v, jw, jnp.asarray(m1),
                                              jnp.asarray(m2), heads=HEADS, H=H, W=W,
                                              interpret=True)
    y, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, xln, k, v)))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def test_plain_forward_matches_jax(jax_reference):
    weights, args, _ = _inputs()
    tw = {n: _torch(a) for n, a in weights.items()}
    y, x1 = mb.fused_mit_block_train_fwd_plain(*map(_torch, args[:4]), tw,
                                               *map(_torch, args[4:]), heads=HEADS, H=H, W=W)
    np.testing.assert_allclose(y.numpy(), jax_reference[0], **TOL)
    # image 0's attention branch is dropped: x1 == x there
    np.testing.assert_array_equal(x1[0].numpy(), args[0][0])


def test_plain_backward_matches_jax_vjp(jax_reference):
    weights, args, dy = _inputs()
    tw = {n: _torch(a) for n, a in weights.items()}
    x, xln, k, v, m1, m2 = map(_torch, args)
    _, x1 = mb.fused_mit_block_train_fwd_plain(x, xln, k, v, tw, m1, m2, heads=HEADS, H=H, W=W)
    got = mb.fused_mit_block_train_bwd_plain(x1, xln, k, v, tw, m1, m2, _torch(dy),
                                             heads=HEADS, H=H, W=W)
    for name, g, want in zip(("dx", "dxln", "dk", "dv"), got, jax_reference[1]):
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **TOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The explicit backward is the derivative of the plain forward (fp32)."""
    weights, args, dy = _inputs(seed=1)
    tw = {n: _torch(a).double().float() for n, a in weights.items()}
    x, xln, k, v, m1, m2 = map(_torch, args)
    leaves = [t.clone().requires_grad_(True) for t in (x, xln, k, v)]
    y, x1 = mb.fused_mit_block_train_fwd_plain(*leaves, tw, m1, m2, heads=HEADS, H=H, W=W)
    want = torch.autograd.grad(y, leaves, _torch(dy))
    got = mb.fused_mit_block_train_bwd_plain(x1.detach(), xln, k, v, tw, m1, m2, _torch(dy),
                                             heads=HEADS, H=H, W=W)
    for name, g, w in zip(("dx", "dxln", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, msg=name, **TOL)


def test_autograd_function_runs_plain_versions_on_cpu():
    """fused_mit_block_train on CPU tensors: the plain forward and backward,
    gradients to x/xln/k/v only, no kernel launch counted."""
    weights, args, dy = _inputs(seed=2)
    tw = {n: _torch(a) for n, a in weights.items()}
    x, xln, k, v, m1, m2 = map(_torch, args)
    mb.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (x, xln, k, v)]
    y = mb.fused_mit_block_train(*leaves, tw, m1, m2, heads=HEADS, H=H, W=W)
    y.backward(_torch(dy))
    want_y, x1 = mb.fused_mit_block_train_fwd_plain(x, xln, k, v, tw, m1, m2,
                                                    heads=HEADS, H=H, W=W)
    torch.testing.assert_close(y.detach(), want_y, rtol=0, atol=0)
    want = mb.fused_mit_block_train_bwd_plain(x1, xln, k, v, tw, m1, m2, _torch(dy),
                                              heads=HEADS, H=H, W=W)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert (mb.block_train_forward.launches, mb.block_train_mlp_backward.launches,
            mb.block_train_attn_backward.launches) == (0, 0, 0)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card raises: there is
    no fallback to the plain version."""
    weights, args, _ = _inputs()
    tw = {n: _torch(a) for n, a in weights.items()}
    x, xln, k, v, m1, m2 = (_torch(a).to("meta") for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        mb.block_train_forward(x, xln, k, v, tw, m1, m2, heads=HEADS, H=H, W=W)
    with pytest.raises(ValueError, match="no kernel"):
        mb.block_train_mlp_backward(x, x, tw, H=H, W=W)
    with pytest.raises(ValueError, match="no kernel"):
        mb.block_train_attn_backward(xln, k, v, x, m1, tw, heads=HEADS)
