"""The serving kernels as ``torch.library`` custom ops.

``surgical_tpu::mit_block_forward``, ``surgical_tpu::mit_block_packed2_forward``
and ``surgical_tpu::mit_stage_forward`` are the port's counterpart of the
Mosaic custom calls that a JAX export of the Pallas-fused graph embeds: the
wrappers of ``kernels/mit_block.py`` (``fused_mit_block``,
``fused_mit_block_packed2``, ``fused_mit_stage``) call them, so
``torch.export`` records each as one opaque node of the serving graph, and a
loaded artifact launches the hand-written kernels. ``surgical_tpu::glue_layernorm``
(``glue_layer_norm``) does the same for the graph glue's LayerNorm on the
card, which a JAX export leaves to XLA. Per op:

- the ``"cpu"`` implementation is the kernel's plain PyTorch version;
- the ``"cuda"`` implementation is the ctypes launch (``*_cuda`` in
  ``kernels/mit_block.py``), which counts itself in the wrapper's
  ``.launches``;
- the fake implementation gives ``empty_like(x)``, for tracing.

No other device has an implementation, so a tensor elsewhere raises. An op
argument cannot be a dict: the weight dicts go in as lists in the fixed key
orders below (``as_list``), and a missing prompt as ``None``. A process that
loads a ``--fused`` artifact imports this module first
(``serving/export.py::load_artifact``), which registers the ops.

The training kernels and the selective scan are not registered as ops: no
exported graph reaches them, and the scan differentiates through its own
``torch.autograd.Function``.
"""

from typing import Optional

import torch
from torch import Tensor

from surgical_tpu_torch.kernels import mit_block as mb

BLOCK_KEYS = ("ln1_scale", "ln1_bias", "wq", "bq", "wo", "bo", "ln2_scale", "ln2_bias",
              "w1", "b1", "wdw", "bdw", "w2", "b2")
PACKED2_KEYS = ("ln1", "wq", "bq", "wo", "bo", "ln2_scale", "ln2_bias", "w1", "b1", "wdw",
                "bdw", "w2", "b2")
STAGE_KEYS = ("ln1", "wkv", "bkv", "wq", "bq", "wo", "bo", "ln2", "w1", "b1", "wdw", "bdw",
              "w2", "b2")
STAGE_SR_KEYS = ("srw", "srb", "lnkv")              # only at sr > 1
STAGE_PROMPT_KEYS = ("sharedw", "sharedb", "lww", "lwb")  # only with a prompt (base)


def stage_keys(sr: int, prompt: bool) -> tuple:
    """The stage op's key order for a stage of reduction ``sr``, with or
    without the in-kernel prompt."""
    return STAGE_KEYS + (STAGE_SR_KEYS if sr > 1 else ()) + (STAGE_PROMPT_KEYS if prompt else ())


def as_list(weights: dict, keys: tuple) -> list:
    return [weights[k] for k in keys]


@torch.library.custom_op("surgical_tpu::mit_block_forward", mutates_args=(), device_types="cpu")
def mit_block_forward(x: Tensor, k: Tensor, v: Tensor, weights: list[Tensor], heads: int,
                      H: int, W: int) -> Tensor:
    return mb.fused_mit_block_plain(x, k, v, dict(zip(BLOCK_KEYS, weights)),
                                    heads=heads, H=H, W=W)


@mit_block_forward.register_kernel("cuda")
def _(x, k, v, weights, heads, H, W):
    return mb.mit_block_forward_cuda(x, k, v, dict(zip(BLOCK_KEYS, weights)),
                                     heads=heads, H=H, W=W)


@mit_block_forward.register_fake
def _(x, k, v, weights, heads, H, W):
    return torch.empty_like(x)


@torch.library.custom_op("surgical_tpu::mit_block_packed2_forward", mutates_args=(),
                         device_types="cpu")
def mit_block_packed2_forward(x: Tensor, k: Tensor, v: Tensor, packed: list[Tensor], H: int,
                              W: int, row_chunks: int) -> Tensor:
    # contiguous, as the kernel's output (the plain unpack is a transposed view)
    return mb.fused_mit_block_packed2_plain(x, k, v, dict(zip(PACKED2_KEYS, packed)),
                                            H=H, W=W, row_chunks=row_chunks).contiguous()


@mit_block_packed2_forward.register_kernel("cuda")
def _(x, k, v, packed, H, W, row_chunks):
    return mb.mit_block_packed2_forward_cuda(x, k, v, dict(zip(PACKED2_KEYS, packed)),
                                             H=H, W=W, row_chunks=row_chunks)


@mit_block_packed2_forward.register_fake
def _(x, k, v, packed, H, W, row_chunks):
    return torch.empty_like(x)


@torch.library.custom_op("surgical_tpu::mit_stage_forward", mutates_args=(), device_types="cpu")
def mit_stage_forward(x: Tensor, base: Optional[Tensor], sw: list[Tensor], heads: int, H: int,
                      W: int, sr: int) -> Tensor:
    return mb.fused_mit_stage_plain(x, base, dict(zip(stage_keys(sr, base is not None), sw)),
                                    heads=heads, H=H, W=W, sr=sr)


@mit_stage_forward.register_kernel("cuda")
def _(x, base, sw, heads, H, W, sr):
    return mb.mit_stage_forward_cuda(x, base, dict(zip(stage_keys(sr, base is not None), sw)),
                                     heads=heads, H=H, W=W, sr=sr)


@mit_stage_forward.register_fake
def _(x, base, sw, heads, H, W, sr):
    return torch.empty_like(x)


@torch.library.custom_op("surgical_tpu::glue_layernorm", mutates_args=(), device_types="cpu")
def glue_layernorm(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    return mb.layer_norm(x, scale, bias).contiguous()  # contiguous, as the kernel's output


@glue_layernorm.register_kernel("cuda")
def _(x, scale, bias):
    return mb.glue_layernorm_cuda(x, scale, bias)


@glue_layernorm.register_fake
def _(x, scale, bias):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
