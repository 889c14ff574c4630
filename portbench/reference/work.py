"""The yardstick's peaks and least-work counts.

``block_work``, ``stage_work``, ``scan_work`` and ``scan_bwd_work`` are
frozen copies of the functions of the same names in ``chip_smoke.py``: the
least bytes and operations of one MiT block, of the stage-4 kernel and of
the selective scan, worked out from their shapes. A kernel's roofline share
is ``bound_s`` of its calls over their device time.

``flops_per_frame`` counts the reference's floating-point operations with
``torch.utils.flop_counter.FlopCounterMode`` on meta tensors: the same count
whatever implements a layer, so a later change to a kernel moves the time
and not the work.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# One NVIDIA H100 SXM, the data sheet's dense rates.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
SFU_OPS = 132 * 16 * 1.98e9  # exp per second: 16 SFU lanes per SM at the boost clock
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}


def block_work(B, N, C, Nkv, hidden):
    """(bytes, bf16 FLOPs) of one MiT block: x, k, v read and y written once,
    its weights once; q/out/fc1/fc2 GEMMs, QK^T and PV, the 3x3 dwconv."""
    flops = B * N * (4 * C * C + 4 * C * hidden + 4 * Nkv * C + 18 * hidden)
    weights = 2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C
    return 2 * (2 * B * N * C + 2 * B * Nkv * C + weights), flops


def stage_work(B, N, C, hidden, depth, Cb, C4):
    """(bytes, bf16 FLOPs) of the stage-4 kernel (sr = 1, so Nkv = N): x and
    the prompt base read, y written, every block's weights once; per block
    the prompt MLP, the kv projection and the block."""
    per_flops = B * N * (2 * Cb * C4 + 2 * C4 * C + 4 * C * C)
    _, blk_flops = block_work(B, N, C, N, hidden)
    weights = depth * (2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C
                       + 2 * C * C + 2 * C + Cb * C4 + C4) + C4 * C + C
    nbytes = 2 * (2 * B * N * C + B * N * Cb + weights)
    return nbytes, depth * (per_flops + blk_flops)


def scan_work(Bt, T, D, N):
    """(bytes, seconds of operations) of the selective scan: x, dt read and y
    written ([Bt, T, D] fp32), B and C read ([Bt, T, N]), A and D once; per
    (t, d, n) one exp on the SFUs and 5 fp32 flops."""
    nbytes = 4 * (3 * Bt * T * D + 2 * Bt * T * N + D * N + D)
    elems = Bt * T * D * N
    return nbytes, max(5 * elems / FP32_FLOPS, elems / SFU_OPS)


def scan_bwd_work(Bt, T, D, N):
    """(bytes, seconds of operations) of the scan's gradient; per (t, d, n)
    one exp and 16 fp32 flops."""
    nbytes = 4 * (5 * Bt * T * D + 4 * Bt * T * N + 2 * (D * N + D))
    elems = Bt * T * D * N
    return nbytes, max(16 * elems / FP32_FLOPS, elems / SFU_OPS)


def bound_s(nbytes, op_seconds):
    """The least time the card could take: bytes at the memory rate or the
    operations at their peak, whichever is longer."""
    return max(nbytes / HBM_BPS, op_seconds)


def count_flops(fn, *args, **kwargs) -> int:
    """Floating-point operations ``fn`` issues (products and convolutions),
    counted on whatever tensors it is given; meta tensors cost nothing."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def meta_state(shapes: dict) -> dict:
    """A state dict of meta tensors of the given shapes."""
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}
