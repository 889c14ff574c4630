"""The numbers ``correct`` compares, and the reference's precision.

``row_gap``: worst over rows of |got - want| / max(|want|, the median row's
|want|) (L2 norms): a row's distance against its own size, or the typical
row's where its own is small.

``norm_gap``: worst over leaves of the gap between the program's norm and
the reference's, measured against the reference's norm of that leaf or of
the median leaf, whichever is larger (``norm_gaps``: every leaf's).

``fp8``: the control's rounding of a product's operand, e4m3 with a
per-tensor scale that maps its largest magnitude to the format's largest
value; under autograd the gradient that flows back through the operand is
rounded to e5m2 the same way (fp8 training's two formats).
"""

from __future__ import annotations

import contextlib

import torch


def row_gap(got, want) -> float:
    got, want = got.double(), want.double()
    d = (got - want).norm(dim=-1)
    w = want.norm(dim=-1)
    return float((d / torch.clamp(torch.maximum(w, w.median()), min=1e-30)).max())


def norm_gaps(got: dict, want: dict, keys) -> torch.Tensor:
    """Each leaf's gap of norms (float64), in the order of ``keys``."""
    keys = list(keys)
    if not keys:
        return torch.zeros(1, dtype=torch.float64)
    w = torch.tensor([float(want[k]) for k in keys], dtype=torch.float64)
    g = torch.tensor([float(got[k]) for k in keys], dtype=torch.float64)
    return (g - w).abs() / torch.clamp(torch.maximum(w, w.median()), min=1e-30)


def norm_gap(got: dict, want: dict, keys) -> float:
    return float(norm_gaps(got, want, keys).max())


def _round(x, dtype, top):
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _FP8.apply(x)
    return _round(x.detach(), torch.float8_e4m3fn, 448.0)


@contextlib.contextmanager
def precision(tf32: bool):
    """Products and convolutions in fp32 (``tf32`` False) or TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
