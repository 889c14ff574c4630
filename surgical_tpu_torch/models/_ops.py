"""Plain PyTorch layers of the fused serving graph, with the JAX package's
roundings (``surgical_tpu/models/mit_fused.py::_ln/_dense/_conv/_bn``).

Activations stay NHWC / [B, N, C] as in the JAX package. Each op computes in
fp32 or in the activation dtype exactly where the JAX graph does and rounds
its result to the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.kernels.mit_block import layer_norm


def layernorm(x, norm: nn.LayerNorm):
    """LayerNorm in fp32 with eps 1e-6 (the fused graph's value for every
    LayerNorm, whatever ``norm.eps`` says) and fp32 parameters."""
    return layer_norm(x, norm.weight, norm.bias)


def dense(x, lin: nn.Linear):
    """x @ W^T with W rounded to x.dtype, fp32 accumulate, fp32 bias, one
    rounding to x.dtype."""
    y = x.float() @ lin.weight.to(x.dtype).float().t()
    if lin.bias is not None:
        y = y + lin.bias
    return y.to(x.dtype)


def conv(x, c: nn.Conv2d, stride: int, padding: int):
    """NHWC conv of x.dtype operands with the weight rounded to x.dtype,
    accumulated in fp32 and rounded once to x.dtype, then + fp32 bias. On
    the CPU it runs in fp32 and rounds after: PyTorch's bf16 convolution
    there returns wrong sums at some shapes (an 8x8 stride-8 kernel over a
    24x24 grid, the SR conv of a 96-px input), where CUDA's accumulates in
    fp32 already."""
    xin, w = x.permute(0, 3, 1, 2), c.weight.to(x.dtype)
    if x.device.type == "cpu":
        y = F.conv2d(xin.float(), w.float(), None, stride, padding).to(x.dtype)
    else:
        y = F.conv2d(xin, w, None, stride, padding)
    y = y.permute(0, 2, 3, 1)
    if c.bias is not None:
        y = (y.float() + c.bias).to(x.dtype)
    return y


def batchnorm(x, bn: nn.BatchNorm2d):
    """Inference BatchNorm from the running statistics (NHWC)."""
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x.float() - bn.running_mean) * inv + bn.bias).to(x.dtype)
