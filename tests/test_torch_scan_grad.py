"""The selective scan's gradient in the port against the JAX package's.

JAX differentiates its scans (``selective_scan_xla``, the associative scan
its CPU path runs, and the sequential ``selective_scan_ref``) with
``jax.grad``; the port has an explicit reverse-time backward
(``selective_scan_plain_backward``) behind the autograd function
``SelectiveScan``, and on the card a backward kernel over the forward's
chunks. Here, on the CPU:

- the port's gradient of all six inputs against ``jax.grad`` of both JAX
  scans, at T in {1, 63, 65, 129} and 1 or 2 videos;
- the same gradient against torch autograd through ``selective_scan_plain``;
- ``torch.autograd.gradcheck`` in float64;
- a plain mirror of the backward kernel's chunked form (the forward's
  sub-chunk start states, the adjoint's chunk pairs, shifted by one step
  against the forward's, folded last first, dB and dC summed per channel
  block and then over the cluster in rank order) held to ``jax.grad`` at the
  chunk edges;
- the wrappers' CPU routes, the kernel's scratch layout and its limit on
  d_state.

CUDA cases (marker ``cuda``) hold the backward kernel to the plain backward
on the card and check that two runs give the same bits.

Stated bounds: fp32 against JAX, max abs error at most 1e-5 of the largest
|gradient| (other summation orders: the associative scan's tree, the sum
over N, the chunk compositions); 1e-6 of it against torch autograd through
the same plain forward; gradcheck at its float64 defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.kernels.selective_scan import selective_scan_ref, selective_scan_xla
from surgical_tpu_torch.kernels import selective_scan as ss

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

REL_JAX, REL_AUTOGRAD = 1e-5, 1e-6
NAMES = ("x", "dt", "A", "B", "C", "D")


def scan_inputs(Bt, T, D=16, N=64, seed=0, dtype=np.float32):
    """(x, dt, A, B, C, D, dy) with Mamba's ranges: dt through softplus, A < 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(dtype)
    dt = np.log1p(np.exp(f(Bt, T, D) - 2.0)).astype(dtype)
    A = -np.exp(0.5 * f(D, N)).astype(dtype)
    return f(Bt, T, D), dt, A, f(Bt, T, N), f(Bt, T, N), f(D), f(Bt, T, D)


def jax_grads(scan, x, dt, A, B, C, D, dy):
    """jax.grad of sum(y * dy) in every input, the scan vmapped over videos."""
    def loss(x, dt, A, B, C, D):
        y = jax.vmap(lambda xs, dts, Bs, Cs: scan(xs, dts, A, Bs, Cs, D))(x, dt, B, C)
        return jnp.sum(y * dy)
    grad = jax.jit(jax.grad(loss, argnums=tuple(range(6))))
    return [np.asarray(g) for g in grad(x, dt, A, B, C, D)]


def port_grads(x, dt, A, B, C, D, dy):
    """The gradients through ``selective_scan`` (the autograd function)."""
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C, D)]
    y = ss.selective_scan(*ins)
    assert isinstance(y.grad_fn, ss.SelectiveScan._backward_cls)
    return [g.numpy() for g in torch.autograd.grad(y, ins, torch.from_numpy(dy))]


def assert_close_to_scale(got, want, rel, names=NAMES):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"d{name}: max abs error {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("oracle", ["xla", "ref"])
@pytest.mark.parametrize("Bt", [1, 2])
@pytest.mark.parametrize("T", [1, 63, 65, 129])
def test_scan_gradient_matches_jax(T, Bt, oracle):
    args = scan_inputs(Bt, T, seed=T + Bt)
    scan = selective_scan_xla if oracle == "xla" else selective_scan_ref
    assert_close_to_scale(port_grads(*args), jax_grads(scan, *args), REL_JAX)


@pytest.mark.parametrize("T", [1, 63, 65, 129])
def test_scan_gradient_matches_torch_autograd(T):
    """The explicit backward against autograd through the plain loop."""
    x, dt, A, B, C, D, dy = (torch.from_numpy(a) for a in scan_inputs(2, T, seed=7))
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    want = torch.autograd.grad(ss.selective_scan_plain(*ins), ins, dy)
    got = ss.selective_scan_backward(x, dt, A, B, C, D, dy)
    assert_close_to_scale([g.numpy() for g in got], [w.numpy() for w in want], REL_AUTOGRAD)


def test_scan_gradcheck_float64():
    ins = [torch.from_numpy(a).requires_grad_()
           for a in scan_inputs(2, 9, D=3, N=5, seed=3, dtype=np.float64)[:6]]
    assert torch.autograd.gradcheck(ss.SelectiveScan.apply, ins)


def selective_scan_chunked_plain_backward(x, dt, A, B, C, D, dy, chunk, sub=ss.SUB_CHUNK,
                                          width=ss.CLUSTER_WARPS):
    """The backward kernel's decomposition in plain PyTorch, fp32. With
    sub-chunks of ``sub`` steps, the backward's chunks of ``chunk`` steps (a
    multiple of ``sub``) and a_t = exp(dt_t A):
    F.  the forward's launches at its own chunks (``scan_chunk``): every chunk
        but the last from zero into its pair (decay, end state), each
        chunk's carry-in folded from the pairs before it, and its rerun,
        which records the state at the start of every sub-chunk;
    B1. for every sub-chunk after the first chunk, from a zero carry,
        backwards: lam_t = dy_t C_t + carry, carry = a_t lam_t, decay = prod
        a_t; the pair is (decay, Q = carry after its first step);
    B2. per chunk, the carry g folds B1's pairs of the sub-chunks after it,
        last first (g = decay g + Q); then per sub-chunk, last first, the
        states forwards from the recorded start state and lam backwards from
        g give the gradients, dA and dD per chunk; dB and dC sum over each
        block of ``width`` channels in channel order, then over the blocks in
        rank order (the cluster's CTAs);
    B3. dA and dD summed over the chunks."""
    a = torch.exp(dt[..., None] * A)                  # [Bt, T, D, N]
    b = (dt * x)[..., None] * B[:, :, None, :]
    T, Dch = x.shape[1], x.shape[2]
    fchunk = ss.scan_chunk(T)
    fspans = [(t0, min(T, t0 + fchunk)) for t0 in range(0, T, fchunk)]
    fwd = []
    for t0, t1 in fspans[:-1]:                                        # F
        h, decay = torch.zeros_like(a[:, 0]), torch.ones_like(a[:, 0])
        for t in range(t0, t1):
            h, decay = a[:, t] * h + b[:, t], decay * a[:, t]
        fwd.append((decay, h))
    states = {}
    for c, (t0, t1) in enumerate(fspans):
        h = torch.zeros_like(a[:, 0])
        for decay, end in fwd[:c]:
            h = decay * h + end
        for t in range(t0, t1):
            if t % sub == 0:
                states[t // sub] = h
            h = a[:, t] * h + b[:, t]
    spans = [(t0, min(T, t0 + chunk)) for t0 in range(0, T, chunk)]
    bwd = {}
    for s0 in range(chunk, T, sub):                                   # B1
        carry, decay = torch.zeros_like(a[:, 0]), torch.ones_like(a[:, 0])
        for t in range(min(T, s0 + sub) - 1, s0 - 1, -1):
            lam = dy[:, t, :, None] * C[:, t, None, :] + carry
            carry, decay = a[:, t] * lam, decay * a[:, t]
        bwd[s0] = (decay, carry)

    def cluster_sum(terms):  # [Bt, D, N] -> [Bt, N]: per block in channel order, then by rank
        total = 0.0
        for r0 in range(0, Dch, width):
            part = 0.0
            for d in range(r0, min(Dch, r0 + width)):
                part = part + terms[:, d]
            total = total + part
        return total

    dx, ddt, dB, dC = (torch.zeros_like(v) for v in (x, dt, B, C))
    dA_parts, dD_parts = [], []
    for t0, t1 in spans:                                              # B2
        carry = torch.zeros_like(a[:, 0])
        for s0 in sorted((s0 for s0 in bwd if s0 >= t1), reverse=True):
            decay, q = bwd[s0]
            carry = decay * carry + q
        dA_c = torch.zeros_like(A)
        for s0 in range(t0 + (t1 - 1 - t0) // sub * sub, t0 - 1, -sub):
            s1 = min(t1, s0 + sub)
            hs = [states[s0 // sub]]
            for t in range(s0, s1):
                hs.append(a[:, t] * hs[-1] + b[:, t])
            for t in range(s1 - 1, s0 - 1, -1):
                k = t - s0
                lam = dy[:, t, :, None] * C[:, t, None, :] + carry
                u = lam * a[:, t] * hs[k]
                lam_B = (lam * B[:, t, None, :]).sum(-1)
                dx[:, t] = dt[:, t] * lam_B + D * dy[:, t]
                ddt[:, t] = (u * A).sum(-1) + x[:, t] * lam_B
                dA_c = dA_c + (u * dt[:, t, :, None]).sum(0)
                dB[:, t] = cluster_sum(lam * (dt[:, t] * x[:, t])[..., None])
                dC[:, t] = cluster_sum(dy[:, t, :, None] * hs[k + 1])
                carry = a[:, t] * lam
        dA_parts.append(dA_c)
        dD_parts.append((dy[:, t0:t1] * x[:, t0:t1]).sum((0, 1)))
    return dx, ddt, sum(dA_parts), dB, dC, sum(dD_parts)                 # B3


@pytest.mark.parametrize("T, chunk, D", [(1, 64, 16), (63, 64, 16), (64, 64, 16),
                                         (65, 64, 16), (129, 64, 16), (197, 64, 16),
                                         (129, 32, 16), (97, 64, 40)])
def test_chunked_backward_mirror_matches_jax(T, chunk, D):
    """One chunk; one chunk and one step past it (the adjoint's decay takes
    the next chunk's first step); three and four chunks with ragged ends;
    five chunks of one sub-chunk; a cluster of three channel blocks, the
    last ragged."""
    args = scan_inputs(2, T, D=D, seed=T)
    got = selective_scan_chunked_plain_backward(*(torch.from_numpy(a) for a in args), chunk)
    assert_close_to_scale([g.numpy() for g in got], jax_grads(selective_scan_ref, *args),
                          REL_JAX)


def test_cpu_routes():
    """On the CPU: no grad -> the plain forward, not the function; under grad
    the function; the backward wrapper is the plain backward; no launches."""
    ss.reset_launches()
    x, dt, A, B, C, D, dy = (torch.from_numpy(a) for a in scan_inputs(1, 20, seed=1))
    y = ss.selective_scan(x, dt, A, B, C, D)
    assert y.grad_fn is None
    torch.testing.assert_close(y, ss.selective_scan_plain(x, dt, A, B, C, D), rtol=0, atol=0)
    with torch.no_grad():
        assert ss.selective_scan(x, dt, A.requires_grad_(), B, C, D).grad_fn is None
    y = ss.selective_scan(x, dt, A, B, C, D)
    y.backward(dy)
    want = ss.selective_scan_plain_backward(x, dt, A.detach(), B, C, D, dy)[2]
    torch.testing.assert_close(A.grad, want, rtol=0, atol=0)
    assert ss.selective_scan.launches == 0 and ss.selective_scan_backward.launches == 0


def test_backward_scratch_layout():
    """The scratch the wrapper allocates, region by region (the C entry point
    checks the same sum), and the forward's sub-chunk states: T = 6000 is
    188 sub-chunks, in chunks of 13 at the H100's 15 active clusters. No dB /
    dC partials: the cluster sums them on chip."""
    Bt, T, D, N = 1, 6000, 128, 64
    assert ss.backward_scratch_floats(Bt, T, D, N, 13) == (
        2 * 175 * D * N + 15 * D * N + 15 * D)
    assert ss.backward_scratch_floats(3, 65, D, N, 5) == 3 * D * N + 3 * D  # one chunk: no pairs
    assert ss.backward_scratch_floats(3, 65, D, N, 1) == (
        2 * 3 * 2 * D * N + 3 * 3 * D * N + 3 * 3 * D)
    assert ss.states_shape(Bt, T, D, N) == (1, 188, D, N)
    assert ss.states_shape(3, 65, D, N) == (3, 3, D, N)


@pytest.mark.parametrize("Bt, T, active, want", [
    (1, 6000, 15, 13),   # 15 clusters: one wave of 13 sub-chunks each
    (1, 2000, 15, 5),    # 13 clusters of 5
    (1, 1, 15, 1),
    (1, 65, 15, 1),      # 3 sub-chunks over 3 clusters
    (3, 777, 15, 5),     # 25 sub-chunks per video: 3 x 5 clusters
    (32, 2000, 15, 9),   # more videos than clusters: 7 chunks of 9 per video, 15 waves
])
def test_backward_chunk_fills_whole_waves(Bt, T, active, want):
    """The cluster launch's chunk: the fewest sub-chunks walked in series
    (waves x chunk), the longest chunk of equal counts."""
    k = ss.backward_chunk(Bt, T, active)
    assert k == want
    subs = -(-T // ss.SUB_CHUNK)
    cost = lambda k: -(-Bt * -(-subs // k) // active) * k
    assert all(cost(k) <= cost(j) for j in range(1, subs + 1))


def test_backward_refuses_a_d_over_one_cluster():
    """D above one cluster of channel blocks (129) and D not a multiple of 4
    (30) are no longer refused: the cluster launch takes one cluster per
    group of channels and the wrapper pads the channels with zeros. What the
    wrappers refuse before any launch now is a d_state above the widest
    build, 128; below it they reach the launch (here torch refuses a CPU
    tensor's device as the launch's current device)."""
    assert ss.CLUSTER_D == 128
    assert ss.backward_layout(129) == (5, 2) and ss.backward_layout(128) == (8, 1)
    for D in (129, 30):
        x, dt, A, B, C, Dv, _ = (torch.from_numpy(a) for a in scan_inputs(1, 4, D=D, seed=2))
        with pytest.raises(ValueError, match="Expected a cuda device"):
            ss.selective_scan_forward(x, dt, A, B, C, Dv, states=True)
    x, dt, A, B, C, Dv, _ = (torch.from_numpy(a) for a in scan_inputs(1, 4, D=8, N=129, seed=2))
    with pytest.raises(ValueError, match="d_state 1 to 128"):
        ss.selective_scan_forward(x, dt, A, B, C, Dv, states=True)


@pytest.mark.cuda
@pytest.mark.parametrize("Bt, T", [(1, 1), (1, 63), (1, 65), (1, 129), (2, 777), (1, 2000)])
def test_backward_kernel_matches_plain_on_the_card(Bt, T):
    """The backward kernel against the plain backward on the card (fp32, TF32
    off), rel L2 at most 1e-4 per gradient; two runs equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the backward kernel has no CPU build")
    args = [torch.from_numpy(a).cuda() for a in scan_inputs(Bt, T, D=128, seed=T)]
    x, dt, A, B, C, D, dy = args
    y, states = ss.selective_scan_forward(x, dt, A, B, C, D, states=True)
    got = ss.selective_scan_backward(x, dt, A, B, C, D, dy, states)
    again = ss.selective_scan_backward(x, dt, A, B, C, D, dy, states)
    want = ss.selective_scan_plain_backward(x, dt, A, B, C, D, dy)
    for name, g, g2, w in zip(NAMES, got, again, want):
        assert torch.equal(g, g2), name
        assert ((g - w).norm() / w.norm()).item() <= 1e-4, name
