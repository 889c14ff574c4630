"""Plain PyTorch layers of the backbone's two graphs, each with the JAX
package's roundings.

``FUSED``: the fused serving and training graphs
(``surgical_tpu/models/mit_fused.py::_ln/_dense/_conv/_bn``): fp32
accumulation and fp32 biases, one rounding to the activation dtype.
``FLAX``: the flax module graph (``surgical_tpu/models/mit_evp.py`` at its
compute dtype): ``nn.Dense`` / ``nn.Conv`` round the product to the compute
dtype and add the bias rounded to it, ``nn.LayerNorm`` takes fp32 statistics
(E[x^2] - E[x]^2, clipped at 0). Both graphs share the BatchNorm of either
mode (``batchnorm``, ``bn_train``) and the dropout (``dropout``).

Activations stay NHWC / [B, N, C] as in the JAX package.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.kernels.mit_block import (glue_layer_norm, glue_layer_norm_fits,
                                                  layer_norm)
from surgical_tpu_torch.parallel.mesh import all_reduce_autograd

# Calls of ``layernorm`` by route: "kernel" (the glue LayerNorm kernel) and
# "plain" (``layer_norm``); ``utils/trace.py::counters()`` shows them.
LAYERNORM_ROUTES = {"kernel": 0, "plain": 0}


def layernorm(x, norm: nn.LayerNorm):
    """LayerNorm in fp32 with eps 1e-6 (the fused graph's value for every
    LayerNorm, whatever ``norm.eps`` says) and fp32 parameters, rounded once
    to x.dtype. A bf16 x on the card of a width the kernel takes
    (``glue_layer_norm_fits``) whose result needs no gradient (grad mode
    off, or neither x nor the affine requires grad) takes one pass of the
    glue LayerNorm kernel (``glue_layer_norm``); every other call, on the
    CPU or under autograd, the plain ``layer_norm``. The two differ only in
    the order of the fp32 sums."""
    w, b = norm.weight, norm.bias
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                              or b.requires_grad)
    if (x.is_cuda and x.dtype == torch.bfloat16 and glue_layer_norm_fits(x.shape[-1])
            and not needs_grad):
        LAYERNORM_ROUTES["kernel"] += 1
        return glue_layer_norm(x, w.float(), b.float())
    LAYERNORM_ROUTES["plain"] += 1
    return layer_norm(x, w, b)


def dense(x, lin: nn.Linear):
    """x @ W^T with W rounded to x.dtype, fp32 accumulate, fp32 bias, one
    rounding to x.dtype."""
    return linear(x, lin.weight, lin.bias)


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


BN_MOMENTUM = 0.99  # flax nn.BatchNorm default, as the flax model uses


def bn_train(x, bn: nn.BatchNorm2d, group=None):
    """Train-mode BatchNorm over NHWC x: (y in x.dtype, (new running mean,
    new running var)), flax's update: fp32 batch statistics with the biased
    variance E[x^2] - E[x]^2 clipped at 0, running statistics at momentum
    0.99.

    With a process ``group`` (a batch sharded over ranks, as JAX's jit of
    the step over a sharded batch computes it) the statistics are those of
    the whole group's batch: the sum, the sum of squares and the count,
    summed over the group by an all-reduce that autograd differentiates.
    ``group=None`` takes this batch's statistics alone."""
    x32 = x.float()
    if group is None:
        mean = x32.mean(dim=(0, 1, 2))
        var = ((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
    else:
        C = x.shape[-1]
        sums = all_reduce_autograd(torch.cat([
            x32.sum(dim=(0, 1, 2)), (x32 * x32).sum(dim=(0, 1, 2)),
            x32.new_full((1,), float(x32[..., 0].numel()))]), group)
        mean = sums[:C] / sums[2 * C]
        var = (sums[C:2 * C] / sums[2 * C] - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    with torch.no_grad():
        new = (BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean,
               BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    return y.to(x.dtype), new


def dropout(x, keep, rate: float):
    """flax ``nn.Dropout``: x / (1 - rate) where ``keep`` (bool, broadcast
    against x), else 0, in x.dtype."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def flax_dense(x, lin: nn.Linear):
    """``nn.Dense`` at x.dtype: x @ W^T with W rounded to x.dtype and the
    product rounded to it, then + the bias rounded to x.dtype."""
    return flax_linear(x, lin.weight, lin.bias)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def flax_conv(x, c: nn.Conv2d, stride: int, padding):
    """``nn.Conv`` at x.dtype (NHWC, ``c.groups`` groups): the sum rounded to
    x.dtype, then + the bias rounded to x.dtype. ``padding`` is pixels on
    every side or "SAME" (flax's default). On the CPU the sum runs in fp32
    and is rounded after, as ``conv`` does."""
    dt = x.dtype
    xin = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pads(x.shape[1 + a], c.kernel_size[a], stride)
                                        for a in (0, 1))
        xin, padding = F.pad(xin, (left, right, top, bottom)), 0
    w = c.weight.to(dt)
    if x.device.type == "cpu":
        y = F.conv2d(xin.float(), w.float(), None, stride, padding, groups=c.groups).to(dt)
    else:
        y = F.conv2d(xin, w, None, stride, padding, groups=c.groups)
    y = y.permute(0, 2, 3, 1)
    if c.bias is not None:
        y = y + c.bias.to(dt)
    return y


def flax_layernorm(x, norm: nn.LayerNorm):
    """``nn.LayerNorm`` at x.dtype: fp32 statistics (E[x^2] - E[x]^2,
    clipped at 0), fp32 affine, one rounding to x.dtype."""
    x32 = x.float()
    m = x32.mean(-1, keepdim=True)
    v = ((x32 * x32).mean(-1, keepdim=True) - m * m).clamp_min(0.0)
    return ((x32 - m) * (torch.rsqrt(v + norm.eps) * norm.weight) + norm.bias).to(x.dtype)


def linear(x, w, b):
    """``dense`` on a weight [out, in] and bias given as tensors."""
    y = x.float() @ w.to(x.dtype).float().t()
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def flax_linear(x, w, b):
    """``flax_dense`` on a weight [out, in] and bias given as tensors."""
    y = x @ w.to(x.dtype).t()
    return y if b is None else y + b.to(x.dtype)


# The two rounding policies that the shared modules (patch embeds, prompt
# cascade, flow encoder, cross-attention, head) take as ``ops=``.
# ``pooled_fp32``: the fused head runs its MLPs on the pooled feature in
# fp32; the flax head keeps the compute dtype.
FUSED = SimpleNamespace(dense=dense, linear=linear, conv=conv, layernorm=layernorm,
                        pooled_fp32=True)
FLAX = SimpleNamespace(dense=flax_dense, linear=flax_linear, conv=flax_conv,
                       layernorm=flax_layernorm, pooled_fp32=False)
