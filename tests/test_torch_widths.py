"""The widths the port's kernels take beyond MiT-b3 and MambaConfig(), on the
CPU: the serving graph at MiT-b0's widths (head width 32 at every stage)
against the JAX package's fused_forward with its Pallas kernels in interpret
mode, the serving wrappers' head-width check, the selective scan at small
and wide (d_state, d_inner) against JAX's Pallas scan in interpret mode, the
CUDA wrappers' padding of d_state and of the channels (through the plain
versions, which is what the padded layout must give), and Mamba at d_state 8
and d_model 128 against JAX's model, forward and gradients. Cases marked
``cuda`` hold the kernels at these widths to their plain versions on the
card and skip without one.

Stated bounds: the b0 serving graph as tests/test_torch_mit_fused.py's
(correlation > 0.999, median relative error < 2e-2 over the pooled
features: both sides bf16, other summation orders); the scan 1e-5 max abs
(fp32, tests/test_torch_mamba.py's bound); the padded layouts 1e-5 of the
largest gradient (fp32, zero terms added in other orders); Mamba's logits
1e-4 max abs and its parameter gradients rel L2 1e-4 per tensor (fp32; the
port's sequential scan against JAX's XLA scan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig, MambaConfig
from surgical_tpu.kernels.selective_scan import selective_scan_pallas
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu_torch.core import config as port_config
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import selective_scan as ss
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_fused import fused_forward
from test_torch_mit_graph import jax_variables, port_model
from test_torch_packed2 import jax_fused_interpret_cfg

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

# MiT-b0's widths and heads (32 / 64 / 160 / 256 over 1 / 2 / 5 / 8: head width
# 32 at every stage), one block per stage, 64-px frames
B0 = BackboneConfig.preset("b0", depths=(1, 1, 1, 1), drop_path_rate=0.0, img_size=64)
B0_HEAD = HeadConfig(embedding_dim=64, hidden=32)
B0_BATCH = 2
ATOL_SCAN, REL_PAD, ATOL_MODEL, REL_GRAD = 1e-5, 1e-5, 1e-4, 1e-4


def test_b0_has_head_width_32_at_every_stage():
    assert [C // h for C, h in zip(B0.embed_dims, B0.num_heads)] == [32] * 4
    assert mb.SERVING_HEAD_DIMS == (32, 64)


def test_b0_serving_graph_matches_jax():
    """The port's serving graph at b0 widths (the kernels' plain versions on
    the CPU) against JAX's fused_forward with its Pallas bodies in interpret
    mode at head width 32, on JAX weights carried from a seeded port model
    (every leaf perturbed, BatchNorm statistics non-trivial)."""
    variables = jax_variables(B0, B0_HEAD, seed=4)
    rng = np.random.default_rng(4)
    img, seg, flow = (rng.standard_normal((B0_BATCH, 64, 64, c)).astype(np.float32)
                      for c in (3, 3, 2))
    want = jax_fused_interpret_cfg(variables, img, seg, flow, B0, B0_HEAD)
    model = port_model(B0, B0_HEAD, variables)
    got = fused_forward(model, torch.from_numpy(img), torch.from_numpy(seg),
                        torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (B0_BATCH, B0_HEAD.embedding_dim)
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    assert corr > 0.999, corr
    assert np.median(rel) < 2e-2, np.median(rel)


@pytest.mark.parametrize("C, heads", [(32, 1), (160, 5), (256, 8), (64, 1), (512, 8)])
def test_serving_check_takes_head_widths_32_and_64(C, heads):
    x = torch.zeros(1, 16, C)
    mb._check_dims(C, heads, 4, 4 * C, 4, 4, x)


def test_serving_wrappers_refuse_head_width_16_without_launching():
    """Head width 16 (the dry run's stage 1) is refused before any launch, in
    the block and in the stage entry, with both built widths named; the
    training kernels take the same two widths and refuse 16 alike (their
    attention backward's plan)."""
    mb.reset_launches()
    C, heads, H = 32, 2, 4
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
    w = {"wq": t(C, C), "bq": t(C), "wo": t(C, C), "bo": t(C), "ln1_scale": t(C),
         "ln1_bias": t(C), "ln2_scale": t(C), "ln2_bias": t(C), "w1": t(C, 4 * C),
         "b1": t(4 * C), "wdw": t(9, 4 * C), "bdw": t(4 * C), "w2": t(4 * C, C), "b2": t(C)}
    x, kv = t(1, H * H, C), t(1, 4, C)
    with pytest.raises(ValueError, match="head_dim 32 or 64: C=32, heads=2"):
        mb.mit_block_forward_cuda(x, kv, kv, w, heads=heads, H=H, W=H)
    sw = {k: v[None] if v.dim() == 2 else v.reshape(1, 1, -1) for k, v in w.items()}
    with pytest.raises(ValueError, match="head_dim 32 or 64"):
        mb.mit_stage_forward_cuda(x, None, sw, heads=heads, H=H, W=H, sr=1)
    with pytest.raises(ValueError, match="head_dim 32 or 64: C=32, heads=2"):
        mb.attn_backward_plan(1, H * H, C, heads, 4)
    assert all(v == 0 for v in mb.launch_counts().values())


# -- the selective scan ----------------------------------------------------------------

def _scan_inputs(Bt, T, D, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(Bt, T, D) - 2.0)).astype(np.float32)  # softplus: positive steps
    A = -np.exp(0.5 * f(D, N)).astype(np.float32)
    return f(Bt, T, D), dt, A, f(Bt, T, N), f(Bt, T, N), f(D), f(Bt, T, D)


@pytest.mark.parametrize("N, D", [(4, 12), (8, 32), (16, 256)])
def test_scan_matches_jax_pallas_at_other_widths(N, D):
    """The port's scan (the plain version on the CPU) against JAX's Pallas
    scan in interpret mode, over two of its 64-step chunks and a ragged end."""
    x, dt, A, B, C, Dv, _ = _scan_inputs(1, 70, D, N, seed=N + D)
    want = np.asarray(selective_scan_pallas(x[0], dt[0], A, B[0], C[0], Dv, chunk=64,
                                            interpret=True))
    t = torch.from_numpy
    got = ss.selective_scan(t(x), t(dt), t(A), t(B), t(C), t(Dv))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=ATOL_SCAN)


@pytest.mark.parametrize("N, width", [(1, 32), (4, 32), (32, 32), (33, 64), (64, 64),
                                      (65, 128), (128, 128), (129, 160), (192, 192),
                                      (200, 256), (256, 256)])
def test_kernel_state_pads_up_to_the_next_build(N, width):
    assert ss.kernel_state(N) == width


def test_scan_refuses_a_d_state_over_128_before_any_launch():
    """A d_state over 128 is no longer refused: it runs as slices of at most
    128 states (tests/test_torch_limits.py), here reaching the launch, which
    torch refuses for a CPU tensor. What the wrappers refuse before any
    launch now is a d_state below 1."""
    ss.reset_launches()
    assert ss.kernel_state(129) == 160
    x, dt, A, B, C, Dv, _ = (torch.from_numpy(a) for a in _scan_inputs(1, 8, 4, 129, seed=1))
    with pytest.raises(ValueError, match="Expected a cuda device"):
        ss.selective_scan_forward(x, dt, A, B, C, Dv)
    with pytest.raises(ValueError, match="d_state of at least 1, got 0"):
        ss.kernel_state(0)
    x, dt, A, B, C, Dv, _ = (torch.from_numpy(a) for a in _scan_inputs(1, 8, 4, 0, seed=1))
    with pytest.raises(ValueError, match="d_state of at least 1"):
        ss.selective_scan_forward(x, dt, A, B, C, Dv)
    assert ss.selective_scan.launches == 0 and ss.selective_scan_backward.launches == 0


def _plain_states(x, dt, A, B, C):
    """The forward kernel's ``states``: h before every SUB_CHUNK-th step."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * B[:, :, None, :]
    h = torch.zeros_like(a[:, 0])
    out = []
    for t in range(x.shape[1]):
        if t % ss.SUB_CHUNK == 0:
            out.append(h)
        h = a[:, t] * h + b[:, t]
    return torch.stack(out, 1)


@pytest.mark.parametrize("N, D", [(4, 12), (8, 30), (16, 256), (100, 6), (128, 8), (64, 128)])
def test_padded_layout_gives_the_plain_scan_and_gradient(N, D):
    """The CUDA wrappers' layout, run through the plain versions: d_state
    padded with zero columns of A, B, C (``pad_state``) leaves y unchanged;
    ``padded_backward`` (channels padded to a multiple of 4, a 128-wide state
    as two launches on its halves) gives the plain gradient, and each launch
    sees a state width the backward is built for, 4k channels, and the
    forward's states of its own inputs."""
    x, dt, A, B, C, Dv, dy = (torch.from_numpy(a) for a in _scan_inputs(2, 70, D, N, seed=N))
    width = ss.kernel_state(N)
    Ap, Bp, Cp = ss.pad_state(A, B, C, width)
    assert Ap.shape == (D, width) and Bp.shape == Cp.shape == (2, 70, width)
    torch.testing.assert_close(ss.selective_scan_plain(x, dt, Ap, Bp, Cp, Dv),
                               ss.selective_scan_plain(x, dt, A, B, C, Dv), rtol=0, atol=ATOL_SCAN)
    states = _plain_states(x, dt, Ap, Bp, Cp)
    assert tuple(states.shape) == ss.states_shape(2, 70, D, width)
    seen = []

    def launch(x, dt, A, B, C, D, dy, states):
        Bt, T, Dch = x.shape
        assert A.shape[1] in ss.BWD_STATE_WIDTHS and Dch % 4 == 0
        assert tuple(states.shape) == ss.states_shape(Bt, T, Dch, A.shape[1])
        torch.testing.assert_close(states, _plain_states(x, dt, A, B, C), rtol=0, atol=0)
        seen.append((A.shape[1], Dch))
        return ss.selective_scan_plain_backward(x, dt, A, B, C, D, dy)

    got = ss.padded_backward(launch, x, dt, A, B, C, Dv, dy, states)
    want = ss.selective_scan_plain_backward(x, dt, A, B, C, Dv, dy)
    assert seen == [(min(width, 64), -(-D // 4) * 4)] * (2 if width == 128 else 1)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= REL_PAD * w.abs().max(), name


@pytest.mark.parametrize("D, cl, groups", [(12, 1, 1), (128, 8, 1), (132, 5, 2),
                                           (256, 8, 2), (512, 8, 4)])
def test_backward_cluster_layout(D, cl, groups):
    """One cluster of up to 8 CTAs of 16 channels per (video, chunk) up to
    128 channels; above, equal clusters per channel group and the groups' dB,
    dC partials in the scratch."""
    assert ss.backward_layout(D) == (cl, groups)
    assert cl * groups * ss.CLUSTER_WARPS >= D
    extra = 2 * groups * 3 * 100 * 16 if groups > 1 else 0
    subs = -(-100 // ss.SUB_CHUNK)
    assert ss.backward_scratch_floats(3, 100, D, 16, 2) == (
        2 * 3 * (subs - 2) * D * 16 + 3 * 2 * D * 16 + 3 * 2 * D + extra)


# -- Mamba at d_state 8, d_model 128 ---------------------------------------------------

WIDE_MAMBA = dict(layers=1, d_model=128, d_state=8, f_dim=32, dropout=0.0)


def test_wide_mamba_matches_jax_forward_and_gradients():
    """d_inner 256 (two channel groups on the card's backward) at d_state 8:
    the logits and every parameter's gradient of sum(logits * w) against
    JAX's model and jax.grad (its XLA scan) on the same weights."""
    cfg = MambaConfig(**WIDE_MAMBA)
    jm = JaxMamba(cfg, backend="xla")
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((1, 40, cfg.f_dim))).astype(np.float32)
    w = rng.standard_normal((1, 1, 40, cfg.out_features)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(7), x)["params"])
    out_j = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x) * w)))(params)
    model = CausalMambaModel(port_config.MambaConfig(**WIDE_MAMBA), device="cpu")
    convert.load_mamba_params(model, params)
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=0, atol=ATOL_MODEL)
    (out * torch.from_numpy(w)).sum().backward()
    want_grads = convert.export_mamba_state_dict(jax.tree.map(np.asarray, jgrads), cfg.layers)
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for k, g in got_grads.items():
        ref = want_grads[k]
        assert np.linalg.norm(g.numpy() - ref) <= REL_GRAD * np.linalg.norm(ref), k


# -- on the card ------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("N, D", [(8, 30), (16, 256), (128, 64)])
def test_scan_kernels_match_plain_on_the_card(N, D):
    """The forward kernel (zero states past d_state) and the backward kernel
    (padded channels, two channel groups, a 128-wide state in halves)
    against the plain versions on the card, fp32 with TF32 off: the
    smoke's bounds (SCAN_BOUNDS, SCAN_BWD_BOUNDS)."""
    _needs_card()
    args = [torch.from_numpy(a).cuda() for a in _scan_inputs(1, 300, D, N, seed=N)]
    x, dt, A, B, C, Dv, dy = args
    y, states = ss.selective_scan_forward(x, dt, A, B, C, Dv, states=True)
    want = ss.selective_scan_plain(x, dt, A, B, C, Dv)
    assert ((y - want).norm() / want.norm()).item() <= 1e-6
    got = ss.selective_scan_backward(x, dt, A, B, C, Dv, dy, states)
    for g, w in zip(got, ss.selective_scan_plain_backward(x, dt, A, B, C, Dv, dy)):
        assert g.shape == w.shape and ((g - w).norm() / w.norm()).item() <= 1e-4


@pytest.mark.cuda
def test_serving_kernels_at_head_width_32_on_the_card():
    """The block kernel at b0's stage 1 (one head of width 32, K = 32
    products) against its plain version on the card (bf16; the smoke's
    BOUNDS[1] rel L2)."""
    _needs_card()
    rng = np.random.default_rng(1)
    t = lambda *s, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).cuda().bfloat16()
    C, side, sr = 32, 56, 8
    w = {"wq": t(C, C, scale=C ** -0.5), "bq": t(C, scale=0.1), "wo": t(C, C, scale=C ** -0.5),
         "bo": t(C, scale=0.1), "ln1_scale": 1 + t(C, scale=0.1), "ln1_bias": t(C, scale=0.1),
         "ln2_scale": 1 + t(C, scale=0.1), "ln2_bias": t(C, scale=0.1),
         "w1": t(C, 4 * C, scale=C ** -0.5), "b1": t(4 * C, scale=0.1),
         "wdw": t(9, 4 * C, scale=1 / 3), "bdw": t(4 * C, scale=0.1),
         "w2": t(4 * C, C, scale=(4 * C) ** -0.5), "b2": t(C, scale=0.1)}
    x, k, v = t(8, side * side, C), t(8, (side // sr) ** 2, C), t(8, (side // sr) ** 2, C)
    with torch.no_grad():
        got = mb.fused_mit_block(x, k, v, w, heads=1, H=side, W=side)
        want = mb.fused_mit_block_plain(x, k, v, w, heads=1, H=side, W=side)
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 1e-3
