"""The lane-packed stage-1 block (packed2) of the port on the CPU: its
``pack_weights2``, the plain version of its kernel and the ``_ROUTE_PACKED2``
route of ``fused_forward``, held to the JAX package (Pallas in interpret
mode) and to the port's own unpacked block.

Stated bounds, fp32 unless named: the plain packed2 against JAX's packed2 at
every ``row_chunks`` within 1e-4 (the JAX test's own bound between its
packed and unpacked kernels), band-by-band against whole-grid within 1e-6,
packed against the port's unpacked block within 1e-5 (the block-diagonal
products add exact zeros in another order); the bf16 route against JAX's
route: correlation > 0.999 and median relative error < 2e-2, the bound of
``tests/test_torch_mit_fused.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.kernels import mit_block as jmb
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.models import mit_fused
from surgical_tpu_torch.models.convert import load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from test_torch_mit_fused import seeded_evp

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

B, H, W, C, NKV = 4, 8, 12, 64, 6
HIDDEN = 4 * C


def _block_weights(rng, scale=0.1):
    r = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {
        "ln1_scale": 1.0 + r(C), "ln1_bias": r(C), "wq": r(C, C), "bq": r(C),
        "wo": r(C, C), "bo": r(C), "ln2_scale": 1.0 + r(C), "ln2_bias": r(C),
        "w1": r(C, HIDDEN), "b1": r(HIDDEN), "wdw": r(9, HIDDEN), "bdw": r(HIDDEN),
        "w2": r(HIDDEN, C), "b2": r(C),
    }


def _inputs(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H * W, C), f(B, NKV, C), f(B, NKV, C)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax_packed2(x, k, v, packed, rc):
    out = jmb.fused_mit_block_packed2(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                                      {n: jnp.asarray(a) for n, a in packed.items()},
                                      H=H, W=W, row_chunks=rc, interpret=True)
    return np.asarray(out)


def test_pack_weights2_matches_jax():
    w = _block_weights(np.random.default_rng(0))
    want = jmb.pack_weights2({k: jnp.asarray(v) for k, v in w.items()})
    got = mb.pack_weights2(_t(w))
    assert got.keys() == want.keys()
    for name, a in want.items():
        a = np.asarray(a)
        assert tuple(got[name].shape) == a.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(a.dtype), name
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)
    # bf16 weights keep their dtype, ln1 becomes fp32 (mit_block.py:783-784)
    got16 = mb.pack_weights2({k: v.to(torch.bfloat16) for k, v in _t(w).items()})
    assert got16["ln1"].dtype == torch.float32 and got16["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("rc", [1, 2, 4])
def test_plain_packed2_matches_jax(rc):
    rng = np.random.default_rng(1)
    x, k, v = _inputs(rng)
    packed = {n: np.asarray(a)
              for n, a in jmb.pack_weights2(
                  {kk: jnp.asarray(a) for kk, a in _block_weights(rng).items()}).items()}
    want = _jax_packed2(x, k, v, packed, rc)
    got = mb.fused_mit_block_packed2(torch.from_numpy(x), torch.from_numpy(k),
                                     torch.from_numpy(v), _t(packed), H=H, W=W, row_chunks=rc)
    assert got.shape == (B, H * W, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bands_match_whole_grid():
    rng = np.random.default_rng(2)
    x, k, v = (torch.from_numpy(a) for a in _inputs(rng))
    packed = mb.pack_weights2(_t(_block_weights(rng)))
    whole = mb.fused_mit_block_packed2_plain(x, k, v, packed, H=H, W=W)
    for rc in (2, 4):
        banded = mb.fused_mit_block_packed2_plain(x, k, v, packed, H=H, W=W, row_chunks=rc)
        torch.testing.assert_close(banded, whole, rtol=1e-6, atol=1e-6)


def test_packed2_equals_unpacked_block():
    """Under block-diagonal weights the packed block is the 1-head block
    applied to each image."""
    rng = np.random.default_rng(3)
    x, k, v = (torch.from_numpy(a) for a in _inputs(rng))
    w = _t(_block_weights(rng))
    want = mb.fused_mit_block(x, k, v, w, heads=1, H=H, W=W)
    got = mb.fused_mit_block_packed2(x, k, v, mb.pack_weights2(w), H=H, W=W, row_chunks=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_full_packed_weights_match_jax():
    """Packed weights whose off-diagonal blocks are not zero: the function
    is the packed one (full 128-wide products), as in the TPU kernel."""
    rng = np.random.default_rng(4)
    x, k, v = _inputs(rng)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    C2, h2 = 2 * C, 2 * HIDDEN
    packed = {"ln1": np.stack([1.0 + r(C2), r(C2)]), "wq": r(C2, C2), "bq": r(C2),
              "wo": r(C2, C2), "bo": r(C2), "ln2_scale": 1.0 + r(C2), "ln2_bias": r(C2),
              "w1": r(C2, h2), "b1": r(h2), "wdw": r(9, h2), "bdw": r(h2), "w2": r(h2, C2),
              "b2": r(C2)}
    for rc in (1, 2):
        want = _jax_packed2(x, k, v, packed, rc)
        got = mb.fused_mit_block_packed2(torch.from_numpy(x), torch.from_numpy(k),
                                         torch.from_numpy(v), _t(packed), H=H, W=W,
                                         row_chunks=rc)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the off-diagonal blocks matter: zeroing them changes the output
    diag = dict(packed, wq=packed["wq"].copy())
    diag["wq"][:C, C:] = 0.0
    other = mb.fused_mit_block_packed2(torch.from_numpy(x), torch.from_numpy(k),
                                       torch.from_numpy(v), _t(diag), H=H, W=W)
    assert (other.numpy() - want).std() > 1e-3


def test_wrapper_checks_and_counts_no_cpu_launch():
    rng = np.random.default_rng(5)
    x, k, v = (torch.from_numpy(a) for a in _inputs(rng))
    packed = mb.pack_weights2(_t(_block_weights(rng)))
    mb.reset_launches()
    mb.fused_mit_block_packed2(x, k, v, packed, H=H, W=W, row_chunks=2)
    assert mb.fused_mit_block_packed2.launches == 0
    with pytest.raises(ValueError, match="even batch"):
        mb.fused_mit_block_packed2(x[:3], k[:3], v[:3], packed, H=H, W=W)
    with pytest.raises(ValueError, match="C = 64"):
        mb.fused_mit_block_packed2(x[..., :32], k[..., :32], v[..., :32], packed, H=H, W=W)
    with pytest.raises(ValueError, match="row_chunks"):
        mb.fused_mit_block_packed2(x, k, v, packed, H=H, W=W, row_chunks=3)
    with pytest.raises(ValueError, match="row_chunks"):
        mb.fused_mit_block_packed2_plain(x, k, v, packed, H=H, W=W, row_chunks=3)


# -- the route in fused_forward ------------------------------------------------

# stage 1 at C = 64 with one head, so that the route takes it; grid 16x16
ROUTE_CFG = BackboneConfig(variant="tiny", embed_dims=(64, 32, 40, 64), num_heads=(1, 2, 4, 8),
                           depths=(2, 1, 1, 1), sr_ratios=(8, 4, 2, 1), qkv_bias=True,
                           drop_path_rate=0.0, img_size=64)
ROUTE_HEAD = HeadConfig(embedding_dim=64, hidden=32)
ROUTE_B = 8
MIN_N = 64  # low enough that the 16x16 stage-1 grid takes row_chunks 2


def jax_fused_interpret_cfg(variables, img, seg, flow, cfg, head, route=False, min_n=MIN_N):
    """JAX fused_forward at ``cfg``/``head`` with every Pallas kernel
    (packed2 included) in interpret mode and, with ``route``, the packed2
    route set and chunking from ``min_n`` tokens. The jit cache is cleared
    around it, since the route is read while tracing."""
    import surgical_tpu.models.mit_fused as jmf

    def wrap(orig):
        def interp(*args, **kw):
            kw["interpret"] = True
            return orig(*args, **kw)
        return interp

    names = ("fused_mit_block", "fused_mit_block_hb", "fused_mit_stage",
             "fused_mit_block_packed2")
    saved = {n: getattr(jmb, n) for n in names}
    routing = (jmf._ROUTE_PACKED2, jmf._PACKED2_MIN_N_FOR_CHUNKING)
    jax.clear_caches()
    try:
        for n, orig in saved.items():
            setattr(jmb, n, wrap(orig))
            setattr(jmf, n, wrap(orig))
        if route:
            jmf._ROUTE_PACKED2, jmf._PACKED2_MIN_N_FOR_CHUNKING = True, min_n
        return np.asarray(jmf.fused_forward(variables["params"], variables["batch_stats"],
                                            img, seg, flow, cfg, head, bt=1), np.float32)
    finally:
        for n, orig in saved.items():
            setattr(jmb, n, orig)
            setattr(jmf, n, orig)
        jmf._ROUTE_PACKED2, jmf._PACKED2_MIN_N_FOR_CHUNKING = routing
        jax.clear_caches()


def _port_forward(model, img, seg, flow, route: bool):
    saved = (mit_fused._ROUTE_PACKED2, mit_fused._PACKED2_MIN_N_FOR_CHUNKING)
    calls = []
    orig = mit_fused.fused_mit_block_packed2

    def spy(*args, **kw):
        calls.append(kw["row_chunks"])
        return orig(*args, **kw)

    mit_fused._ROUTE_PACKED2, mit_fused._PACKED2_MIN_N_FOR_CHUNKING = route, MIN_N
    mit_fused.fused_mit_block_packed2 = spy
    try:
        out = mit_fused.fused_forward(model, torch.from_numpy(img), torch.from_numpy(seg),
                                      torch.from_numpy(flow)).numpy()
    finally:
        mit_fused._ROUTE_PACKED2, mit_fused._PACKED2_MIN_N_FOR_CHUNKING = saved
        mit_fused.fused_mit_block_packed2 = orig
    return out, calls


def test_route_matches_jax_route_and_route_off():
    variables, img, seg, flow = seeded_evp(ROUTE_CFG, ROUTE_HEAD, ROUTE_B)
    model = MiTEVP(ROUTE_CFG, ROUTE_HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    got, calls = _port_forward(model, img, seg, flow, route=True)
    assert calls == [2, 2]  # both stage-1 blocks, banded as JAX bands them
    off, none = _port_forward(model, img, seg, flow, route=False)
    assert none == []
    assert mit_fused._ROUTE_PACKED2 is False  # the default, restored
    want = jax_fused_interpret_cfg(variables, img, seg, flow, ROUTE_CFG, ROUTE_HEAD,
                                   route=True)
    for ref in (want, off):
        assert got.shape == ref.shape == (ROUTE_B, ROUTE_HEAD.embedding_dim)
        corr = np.corrcoef(got.ravel(), ref.ravel())[0, 1]
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
        assert corr > 0.999, corr
        assert np.median(rel) < 2e-2, np.median(rel)
