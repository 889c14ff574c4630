"""Mamba S6 selective scan: the Hopper CUDA kernels (``csrc/selective_scan.cu``)
and their plain PyTorch versions, forward and backward.

Port of ``surgical_tpu/kernels/selective_scan.py`` (``selective_scan_pallas``),
batched over videos where the JAX package vmaps:

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

x, dt [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D] -> y [Bt, T, D], all fp32
with an fp32 state that starts at zero. Each video runs at its true length:
the JAX kernel's padding to chunks of 128 exists for TPU block shapes. The
kernel splits time into ``scan_chunk(T)`` steps per chunk: one launch scans
every chunk but the last from zero into its (decay, end state) pair, a
second folds the pairs before each chunk into its carry-in and reruns the
chunk from there (a video of one chunk takes the second launch alone).

The gradient (the JAX package differentiates its XLA scan; the Pallas
kernel has none) runs the adjoint backwards in time, with a_t = exp(dt_t A):

    λ_t = dy_t ⊗ C_t + a_{t+1} ⊙ λ_{t+1},  λ_{T+1} = 0
    dx_t = dt_t ⊙ Σ_n λ_t B_t + D ⊙ dy_t
    ddt_t = Σ_n λ_t ⊙ (A ⊙ a_t ⊙ h_{t-1} + B_t ⊗ x_t)
    dA = Σ_t λ_t ⊙ a_t ⊙ h_{t-1} ⊙ dt_t,   dD = Σ_t dy_t ⊙ x_t
    dB_t = Σ_d λ_t ⊙ (dt_t ⊙ x_t),         dC_t = Σ_d dy_t ⊗ h_t

(dA and dD also sum over the videos). ``selective_scan_backward`` computes
it, on the card from the states the forward kernel writes at the start of
every SUB_CHUNK steps, which the autograd function asks for and keeps.

The kernels are built at state widths 32, 64 and 128 (the backward at 32
and 64); a ``d_state`` runs at the next of them (``kernel_state``) with
zero states past it: the forward kernel fills the zeros as it loads A, B
and C, the backward's wrapper pads them with zero columns and the channels
to a multiple of 4, all exact. The states of a channel evolve independently,
so a wider state is cut into slices: the forward runs a ``d_state`` above
128 as one launch per slice of at most 128 states (``state_slices``), each
at its own width, y the sum of the slices' outputs and D in the first slice
only; the backward runs the (padded) state as one launch per 64-wide slice
(a last slice of 32 at its own width), dx and ddt the slices' sums, dA, dB,
dC their concatenation. Above 128 channels the backward takes one
thread-block cluster per group of channels. Any ``d_state`` of at least 1
runs.

Each wrapper runs its plain version only for tensors that lie on the CPU;
for CUDA tensors it launches its kernel or raises. ``selective_scan`` is
differentiable on both: under grad it goes through ``SelectiveScan``, an
autograd function whose CUDA forward launches the forward kernel and whose
backward launches the backward kernel. The wrappers count their launches in
``selective_scan.launches`` and ``selective_scan_backward.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from surgical_tpu_torch.kernels import _build

STATE_WIDTHS = (32, 64, 128)  # the forward kernel's builds; a d_state pads up to the next
BWD_STATE_WIDTHS = (32, 64)   # the backward's: a wider state runs in slices of 64
MAX_STATE = STATE_WIDTHS[-1]  # the widest slice of one forward launch
SUB_CHUNK = 32   # steps the kernel stages and reduces at once; a chunk is a multiple
MAX_CHUNKS = 32  # chunks per video at most: the carry fold reads at most 31 pairs
BWD_WARPS = 8    # channels per block of the backward's chunk-pair launch
CLUSTER_WARPS = 16  # channels per CTA of the backward's main launch (one warp each)
CLUSTER_MAX = 8     # CTAs per thread-block cluster at most, the portable size
CLUSTER_D = CLUSTER_WARPS * CLUSTER_MAX  # most channels one cluster holds


def scan_chunk(T: int) -> int:
    """Steps per chunk of the kernel at T steps: the smallest multiple of
    SUB_CHUNK, and at least two of them, that cuts T into at most MAX_CHUNKS
    chunks (64 up to T = 2048, 192 at T = 6000)."""
    return SUB_CHUNK * max(2, -(-T // (SUB_CHUNK * MAX_CHUNKS)))


def selective_scan_plain(x, dt, A, B, C, D):
    """Sequential loop over time in plain PyTorch (the counterpart of
    ``selective_scan_ref``): the exp and input terms for every step at once,
    then h_t = a_t * h_{t-1} + b_t step by step, then y from every h_t."""
    a = torch.exp(dt[..., None] * A)                 # [Bt, T, D, N]
    b = (dt * x)[..., None] * B[:, :, None, :]
    hs = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(x.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h)
        hs[:, t] = h
    return torch.einsum("btdn,btn->btd", hs, C) + D * x


def _ptr(t: torch.Tensor, shape, name: str) -> int:
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous fp32 CUDA tensors, got "
                         f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.data_ptr()


def selective_scan_plain_backward(x, dt, A, B, C, D, dy):
    """The scan's gradient in plain PyTorch (the counterpart of
    ``selective_scan_backward``): the states h_t step by step forwards, the
    adjoint λ_t step by step backwards, then every input's gradient from
    them (formulas in the module docstring). Returns (dx, ddt, dA, dB, dC,
    dD) in the inputs' shapes."""
    a = torch.exp(dt[..., None] * A)                 # [Bt, T, D, N]
    b = (dt * x)[..., None] * B[:, :, None, :]
    T = x.shape[1]
    hs = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(T):
        h = torch.addcmul(b[:, t], a[:, t], h)
        hs[:, t] = h
    dyC = dy[..., None] * C[:, :, None, :]
    lam = torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])                # a_{t+1} λ_{t+1}
    for t in range(T - 1, -1, -1):
        lam[:, t] = dyC[:, t] + carry
        carry = a[:, t] * lam[:, t]
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
    lam_B = torch.einsum("btdn,btn->btd", lam, B)
    decay = lam * a * h_prev                         # λ_t a_t h_{t-1}
    dx = dt * lam_B + D * dy
    ddt = torch.einsum("btdn,dn->btd", decay, A) + x * lam_B
    dA = torch.einsum("btdn,btd->dn", decay, dt)
    dB = torch.einsum("btdn,btd->btn", lam, dt * x)
    dC = torch.einsum("btd,btdn->btn", dy, hs)
    dD = (dy * x).sum((0, 1))
    return dx, ddt, dA, dB, dC, dD


def _chunks(T: int) -> tuple[int, int]:
    chunk = scan_chunk(T)
    return chunk, -(-T // chunk)


def states_shape(Bt: int, T: int, D: int, N: int) -> tuple:
    """Shape of the sub-chunk start states the forward kernel writes for the
    backward: the state h before steps 0, SUB_CHUNK, 2 SUB_CHUNK, ..."""
    return (Bt, -(-T // SUB_CHUNK), D, N)


@functools.lru_cache(maxsize=256)
def backward_chunk(Bt: int, T: int, active: int) -> int:
    """Sub-chunks per chunk (K2) of the backward's cluster launch, one cluster
    per (video, chunk), when ``active`` clusters fit on the card at once:
    the K2 that finishes soonest, counting the sub-chunks a cluster walks in
    series (waves x K2), the longest of equal counts (fewer pairs to write
    and fold). With the H100's 15 clusters and one video: 13 at T = 6000 (15
    clusters, one wave), 5 at T = 2000 (13 clusters)."""
    subs = -(-T // SUB_CHUNK)
    best = (None, 1)
    for k in range(1, subs + 1):
        cost = -(-Bt * -(-subs // k) // active) * k
        if best[0] is None or cost <= best[0]:
            best = (cost, k)
    return best[1]


def backward_layout(D: int) -> tuple[int, int]:
    """(CTAs per cluster, channel groups) of the backward's cluster launch
    at D channels (a multiple of 4): blocks of CLUSTER_WARPS channels, the
    fewest groups of at most CLUSTER_MAX blocks, the blocks spread evenly
    over them. One group up to CLUSTER_D = 128 channels."""
    blocks = -(-D // CLUSTER_WARPS)
    groups = -(-blocks // CLUSTER_MAX)
    return -(-blocks // groups), groups


def backward_scratch_floats(Bt: int, T: int, D: int, N: int, sub_chunks: int) -> int:
    """fp32 scratch of the backward kernel at ``sub_chunks`` (K2) per chunk, in
    the order ``csrc/selective_scan.cu`` lays it out: the adjoint pairs of the
    sub-chunks after the first chunk [2, Bt, subs - K2, D, N], then the
    per-chunk partials of dA [Bt, chunks, D, N] and of dD [Bt, chunks, D],
    then with more than one channel group (D > CLUSTER_D) the groups' dB and
    dC [groups, 2, Bt, T, N]. With one group dB and dC are summed on chip,
    across the thread-block cluster."""
    subs = -(-T // SUB_CHUNK)
    chunks = -(-subs // sub_chunks)
    groups = backward_layout(D)[1]
    return (2 * Bt * max(0, subs - sub_chunks) * D * N + Bt * chunks * D * N
            + Bt * chunks * D + (2 * groups * Bt * T * N if groups > 1 else 0))


def kernel_state(N: int) -> int:
    """The state width the kernels run a ``d_state`` of N at: up to MAX_STATE
    the smallest of STATE_WIDTHS that holds it; above, whole slices of
    MAX_STATE and the smallest width that holds the rest (192 at 192, 256 at
    200). Raises ValueError below 1."""
    if N < 1:
        raise ValueError(f"the scan kernels take a d_state of at least 1, got {N}")
    full, rest = divmod(N, MAX_STATE)
    return full * MAX_STATE + (min(w for w in STATE_WIDTHS if w >= rest) if rest else 0)


def state_slices(N: int) -> list[slice]:
    """The forward's launches at a ``d_state`` of N: slices of at most
    MAX_STATE states, each run at ``kernel_state`` of its own size."""
    return [slice(lo, min(lo + MAX_STATE, N)) for lo in range(0, N, MAX_STATE)]


def _pad(t: torch.Tensor, last: int = 0, second: int = 0) -> torch.Tensor:
    """t with ``last`` zeros appended on its last axis and ``second`` on the
    one before (a new tensor only where something is added)."""
    if not (last or second):
        return t
    return F.pad(t, (0, last, 0, second) if second else (0, last))


def pad_state(A, B, C, width: int):
    """A [D, N], B, C [Bt, T, N] with zero columns up to ``width`` states:
    the padded states start at zero, take no input (B = 0) and are not read
    (C = 0), so y and every other state are unchanged."""
    extra = width - A.shape[1]
    return _pad(A, extra), _pad(B, extra), _pad(C, extra)


def padded_backward(launch, x, dt, A, B, C, D, dy, states):
    """The backward through the kernel layout: d_state padded to
    ``kernel_state`` (the forward's ``states`` already are), the channels to
    a multiple of 4 with zeros (x = dt = dy = 0 and A = D = 0: a padded
    channel's state and adjoint stay zero), and a state wider than 64 run as
    one launch per 64-wide slice, a last slice of 32 at its own width (the
    states of a channel evolve independently: dx and ddt are the slices'
    sums in slice order, the skip term D dy in the first slice only; dA, dB,
    dC their concatenation). ``launch(x, dt, A, B, C, D, dy, states)``
    computes the gradient at a width of BWD_STATE_WIDTHS. Returns the six
    gradients in the inputs' shapes."""
    Dch, N = A.shape
    width, extra_d = kernel_state(N), -Dch % 4
    if width == N and width in BWD_STATE_WIDTHS and not extra_d:  # the kernel's layout
        return launch(x, dt, A, B, C, D, dy, states)
    A, B, C = pad_state(_pad(A, 0, extra_d), B, C, width)
    x, dt, dy, Dp = (_pad(t, extra_d) for t in (x, dt, dy, D))
    states = _pad(states, 0, extra_d)
    if width in BWD_STATE_WIDTHS:
        dx, ddt, dA, dB, dC, dD = launch(x, dt, A, B, C, Dp, dy, states)
    else:
        step = BWD_STATE_WIDTHS[-1]
        parts = [launch(x, dt, A[:, s].contiguous(), B[..., s].contiguous(),
                        C[..., s].contiguous(), Dp if s.start == 0 else torch.zeros_like(Dp),
                        dy, states[..., s].contiguous())
                 for s in (slice(lo, min(lo + step, width)) for lo in range(0, width, step))]
        dx, ddt, dD = parts[0][0], parts[0][1], parts[0][5]
        for part in parts[1:]:
            dx, ddt = dx + part[0], ddt + part[1]
        dA, dB, dC = (torch.cat([p[i] for p in parts], -1) for i in (2, 3, 4))
    return (dx[..., :Dch].contiguous(), ddt[..., :Dch].contiguous(),
            dA[:Dch, :N].contiguous(), dB[..., :N].contiguous(), dC[..., :N].contiguous(),
            dD[:Dch].contiguous())


def selective_scan_forward(x, dt, A, B, C, D, states: bool = False):
    """The forward kernel on CUDA tensors: (y, states). With ``states`` the
    kernel also writes the state at the start of every SUB_CHUNK steps
    (``states_shape`` at the kernel's width, ``kernel_state(d_state)``),
    which the backward kernel reruns from; else states is None and the
    launches write only y and their chunk pairs. Above MAX_STATE states one
    launch per ``state_slices`` slice: y is the slices' sum in slice order,
    D taken by the first slice, and the slices' states lie side by side on
    the last axis (each padded to its own width)."""
    n = A.shape[1]
    if kernel_state(n) <= MAX_STATE:
        return _forward_launch(x, dt, A, B, C, D, states)
    zero_d = torch.zeros_like(D)
    y, hs = None, []
    for s in state_slices(n):
        ys, h = _forward_launch(x, dt, A[:, s].contiguous(), B[..., s].contiguous(),
                                C[..., s].contiguous(), D if s.start == 0 else zero_d, states)
        y = ys if y is None else y.add_(ys)
        hs.append(h)
    return y, torch.cat(hs, -1) if states else None


def _forward_launch(x, dt, A, B, C, D, states: bool):
    """The forward kernel's launches at a ``d_state`` of at most MAX_STATE,
    counted in ``selective_scan.launches``."""
    Bt, T, Dch = x.shape
    n = A.shape[1]
    N = kernel_state(n)  # the kernel's width: zero states past n, filled as it loads
    y = torch.empty_like(x)
    chunk, chunks = _chunks(T)
    f32 = dict(dtype=torch.float32, device=x.device)
    pairs = torch.empty(2, Bt, chunks - 1, Dch, N, **f32) if chunks > 1 else None
    hs = torch.empty(states_shape(Bt, T, Dch, N), **f32) if states else None
    with torch.cuda.device(x.device):  # the launch's current device
        err = _build.load().selective_scan_forward(
            _ptr(x, (Bt, T, Dch), "x"), _ptr(dt, (Bt, T, Dch), "dt"), _ptr(A, (Dch, n), "A"),
            _ptr(B, (Bt, T, n), "B"), _ptr(C, (Bt, T, n), "C"), _ptr(D, (Dch,), "D"),
            y.data_ptr(), None if pairs is None else pairs.data_ptr(),
            None if hs is None else hs.data_ptr(), Bt, T, Dch, N, n, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "selective_scan_forward")
    selective_scan.launches += 1
    return y, hs


def selective_scan_backward(x, dt, A, B, C, D, dy, states=None):
    """(dx, ddt, dA, dB, dC, dD) of the scan at the output gradient ``dy``.
    CPU tensors take ``selective_scan_plain_backward``; CUDA tensors the
    backward kernel through ``padded_backward``, which needs the forward's
    sub-chunk start ``states`` (``selective_scan_forward(..., states=True)``,
    at the kernel's state width)."""
    if x.device.type == "cpu":
        return selective_scan_plain_backward(x, dt, A, B, C, D, dy)
    if not x.is_cuda:
        raise ValueError(f"selective_scan_backward: no kernel for device {x.device}")
    Bt, T, Dch = x.shape
    width = kernel_state(A.shape[1])
    if states is None:
        raise ValueError("selective_scan_backward: the kernel needs the forward's sub-chunk "
                         "states (selective_scan_forward(..., states=True))")
    if tuple(states.shape) != states_shape(Bt, T, Dch, width):
        raise ValueError(f"selective_scan_backward: states {tuple(states.shape)} != "
                         f"{states_shape(Bt, T, Dch, width)}")
    return padded_backward(_backward_launch, x, dt, A, B, C, D, dy, states)


def _backward_launch(x, dt, A, B, C, D, dy, states):
    """The backward kernel's launches at a state width of BWD_STATE_WIDTHS and
    a multiple of 4 channels, counted in ``selective_scan_backward.launches``
    (once per 64-wide slice of a wider state)."""
    Bt, T, Dch = x.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA, dB, dC, dD = (torch.empty(Dch, N, **f32), torch.empty(Bt, T, N, **f32),
                      torch.empty(Bt, T, N, **f32), torch.empty(Dch, **f32))
    # scratch: the adjoint's sub-chunk pairs and the partials of dA and dD
    # that the last launch sums in a fixed order
    k2 = backward_chunk(Bt * backward_layout(Dch)[1], T, _active_clusters(x.device, Dch, N))
    n_scratch = backward_scratch_floats(Bt, T, Dch, N, k2)
    if n_scratch >= 2 ** 31:
        raise ValueError(f"selective_scan_backward: {n_scratch} floats of scratch at "
                         f"[Bt={Bt}, T={T}, D={Dch}]: split the batch")
    scratch = torch.empty(n_scratch, **f32)
    with torch.cuda.device(x.device):  # the launch's current device
        err = _build.load().selective_scan_backward(
            _ptr(x, (Bt, T, Dch), "x"), _ptr(dt, (Bt, T, Dch), "dt"), _ptr(A, (Dch, N), "A"),
            _ptr(B, (Bt, T, N), "B"), _ptr(C, (Bt, T, N), "C"), _ptr(D, (Dch,), "D"),
            _ptr(dy, (Bt, T, Dch), "dy"), _ptr(states, states_shape(Bt, T, Dch, N), "states"),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), scratch.data_ptr(), Bt, T, Dch, N, k2, n_scratch,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "selective_scan_backward")
    selective_scan_backward.launches += 1
    return dx, ddt, dA, dB, dC, dD


class SelectiveScan(torch.autograd.Function):
    """The differentiable scan: on the CPU the plain forward and the plain
    backward, on the card the forward kernel (its sub-chunk start states
    kept) and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        if x.is_cuda:
            y, states = selective_scan_forward(x, dt, A, B, C, D, states=True)
        else:
            y, states = selective_scan_plain(x, dt, A, B, C, D), None
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, D, states = ctx.saved_tensors
        return selective_scan_backward(x, dt, A, B, C, D, dy.contiguous(), states)


def selective_scan(x, dt, A, B, C, D):
    """y [Bt, T, D] of the selective scan (see the module docstring),
    differentiable in every input."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"selective_scan: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        return SelectiveScan.apply(x, dt, A, B, C, D)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, A, B, C, D)
    return selective_scan_forward(x, dt, A, B, C, D)[0]


@functools.lru_cache(maxsize=16)
def _active_clusters(device: torch.device, D: int, N: int) -> int:
    """Clusters of the backward's main launch that fit on ``device`` at once."""
    with torch.cuda.device(device):
        active = backward_resources(D, N)["active_clusters"]
    if active < 1:
        raise RuntimeError(f"selective_scan_backward: no cluster of its launch fits on {device}")
    return active


def backward_resources(D: int = 128, N: int = 64) -> dict:
    """What the backward's cluster launch holds on the card at D channels and
    a state width N of BWD_STATE_WIDTHS: registers per thread, static and
    dynamic shared memory per CTA, spill bytes per thread, CTAs per SM and
    clusters active at once (CUDA's own attribute and occupancy queries)."""
    if N not in BWD_STATE_WIDTHS:
        raise ValueError(f"the backward kernel is built at state widths {BWD_STATE_WIDTHS}, "
                         f"got {N}")
    fn = _build.load().selective_scan_backward_resources
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _build.check(fn(ctypes.addressof(out), backward_layout(D)[0], N),
                 "selective_scan_backward_resources")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "ctas_per_sm",
            "active_clusters")
    return dict(zip(keys, out))


selective_scan.launches = 0
selective_scan_backward.launches = 0


def reset_launches() -> None:
    selective_scan.launches = 0
    selective_scan_backward.launches = 0
