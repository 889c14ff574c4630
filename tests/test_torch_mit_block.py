"""The port's plain block / stage functions (surgical_tpu_torch.kernels.
mit_block, the CPU side of the Hopper kernels) against the JAX package's
Pallas kernels in interpret mode, in fp32 on the same seeded inputs.

Tolerance: atol = rtol = 1e-4 (fp32 on both sides; the two differ only in
summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.kernels import mit_block as jmb
from surgical_tpu.models.mit_evp import MiTBlock
from surgical_tpu_torch.kernels import mit_block as tmb

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, W, C, NKV = 2, 8, 8, 16, 16
N = H * W


def _block_params(heads, sr, seed):
    x0 = jnp.zeros((B, N, C), jnp.float32)
    block = MiTBlock(dim=C, num_heads=heads, mlp_ratio=4, sr_ratio=sr, qkv_bias=True,
                     drop=0.0, attn_drop=0.0, drop_path=0.0)
    p = block.init(jax.random.key(seed), x0, H, W)["params"]
    # non-trivial LayerNorm affines so the kernels' LN parameters matter
    rng = np.random.default_rng(seed)
    for name in ("norm1", "norm2"):
        p[name] = {"scale": 1.0 + 0.1 * rng.standard_normal(C).astype(np.float32),
                   "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}
    return jax.tree.map(np.asarray, p)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("variant", ["block_bt1", "block_bt2", "block_hb"])
def test_block_plain_matches_pallas(heads, variant):
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    k = rng.standard_normal((B, NKV, C)).astype(np.float32)
    v = rng.standard_normal((B, NKV, C)).astype(np.float32)
    w = jmb.block_weights_from_params(_block_params(heads, 1, heads))
    w = {key: np.asarray(val, np.float32) for key, val in w.items()}
    if variant == "block_hb":
        want = jmb.fused_mit_block_hb(x, None, k, v, w, heads=heads, H=H, W=W, bt=1,
                                      interpret=True)
    else:
        want = jmb.fused_mit_block(x, None, k, v, w, heads=heads, H=H, W=W,
                                   bt=int(variant[-1]), interpret=True)
    got = tmb.fused_mit_block(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v),
                              _torch_tree(w), heads=heads, H=H, W=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _stage_setup(sr, depth=2, heads=2, c4=4, cb=8, stage=3):
    rng = np.random.default_rng(10 + sr)
    params = {f"block{stage}_{d}": _block_params(heads, sr, 20 + d) for d in range(depth)}
    pg = {f"lightweight_mlp{stage}_{d}": {
        "kernel": 0.3 * rng.standard_normal((cb, c4)).astype(np.float32),
        "bias": 0.1 * rng.standard_normal(c4).astype(np.float32)} for d in range(depth)}
    pg[f"shared_mlp{stage}"] = {"kernel": 0.3 * rng.standard_normal((c4, C)).astype(np.float32),
                                "bias": 0.1 * rng.standard_normal(C).astype(np.float32)}
    params["prompt_generator"] = pg
    sw = jmb.stage_weights_from_params(params, stage, depth, dtype=jnp.float32)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    base = 0.5 * rng.standard_normal((B, N, cb)).astype(np.float32)
    return jax.tree.map(np.asarray, sw), x, base


@pytest.mark.parametrize("sr", [1, 2])
@pytest.mark.parametrize("with_base", [True, False])
def test_stage_plain_matches_pallas(sr, with_base):
    heads = 2
    sw, x, base = _stage_setup(sr, heads=heads)
    base = base if with_base else None
    want = jmb.fused_mit_stage(x, base, sw, heads=heads, H=H, W=W, sr=sr, bt=1, phases=1,
                               interpret=True)
    got = tmb.fused_mit_stage(torch.from_numpy(x),
                              None if base is None else torch.from_numpy(base),
                              _torch_tree(sw), heads=heads, H=H, W=W, sr=sr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_do_not_count_launches():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    tmb.reset_launches()
    sw, x, base = _stage_setup(1)
    tmb.fused_mit_stage(torch.from_numpy(x), torch.from_numpy(base), _torch_tree(sw),
                        heads=2, H=H, W=W, sr=1)
    assert tmb.fused_mit_block.launches == 0 and tmb.fused_mit_stage.launches == 0
