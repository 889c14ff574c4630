"""Mamba S6 selective scan: the Hopper CUDA kernel (``csrc/selective_scan.cu``)
and its plain PyTorch version.

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

The wrapper runs the plain version only for tensors that lie on the CPU. For
CUDA tensors it launches the kernel or raises; it raises too when grad mode
is on and an input requires grad, since the kernel has no backward (the CPU
version is differentiable). It counts its launches in
``selective_scan.launches``.
"""

from __future__ import annotations

import torch

from surgical_tpu_torch.kernels import _build

STATE = 64  # the one d_state the kernel takes: MambaConfig()'s
SUB_CHUNK = 32   # steps the kernel stages and reduces at once; a chunk is a multiple
MAX_CHUNKS = 32  # chunks per video at most: the carry fold reads at most 31 pairs


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


def selective_scan(x, dt, A, B, C, D):
    """y [Bt, T, D] of the selective scan (see the module docstring)."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, A, B, C, D)
    if not x.is_cuda:
        raise ValueError(f"selective_scan: no kernel for device {x.device}")
    _build.refuse_grad("selective_scan", x, dt, A, B, C, D)
    Bt, T, Dch = x.shape
    N = A.shape[1]
    if N != STATE:
        raise ValueError(f"kernel takes d_state == {STATE}, got {N}")
    y = torch.empty_like(x)
    chunk = scan_chunk(T)
    chunks = -(-T // chunk)
    pairs = (torch.empty(2, Bt, chunks - 1, Dch, N, dtype=torch.float32, device=x.device)
             if chunks > 1 else None)
    err = _build.load().selective_scan_forward(
        _ptr(x, (Bt, T, Dch), "x"), _ptr(dt, (Bt, T, Dch), "dt"), _ptr(A, (Dch, N), "A"),
        _ptr(B, (Bt, T, N), "B"), _ptr(C, (Bt, T, N), "C"), _ptr(D, (Dch,), "D"),
        y.data_ptr(), None if pairs is None else pairs.data_ptr(), Bt, T, Dch, N, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "selective_scan_forward")
    selective_scan.launches += 1
    return y


selective_scan.launches = 0


def reset_launches() -> None:
    selective_scan.launches = 0
