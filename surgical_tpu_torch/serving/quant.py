"""Opt-in int8 weight quantization for the extraction path.

Port of ``surgical_tpu/serving/quant.py`` (``quantize_tree``,
``dequantize_tree``, ``quantization_error``) over a state dict: weight-only,
symmetric, per output channel. Every floating tensor of two or more
dimensions is held as int8 with an fp32 scale per output channel,
``scale = amax / 127 + 1e-12`` and ``q = clip(round(w / scale), -127, 127)``
(round half to even), and is dequantized to ``(q.float() * scale).to(bf16)``
at each dispatch. Biases, LayerNorm and BatchNorm parameters and statistics,
and integer tensors pass through unchanged.

The JAX package reduces over every axis but the last (flax kernels are
[in, out] / HWIO); in the port's layout ([out, in] / OIHW, the depthwise
conv's [C, 1, 3, 3]) the output channel is axis 0, so the port reduces over
every axis but the first. The joint ``in_proj_weight`` [3C, C] of the
cross-attentions holds JAX's three query / key / value kernels row for row,
and its per-row scales are theirs.

Features from int8 weights are not bit-compatible with the reference's
fp16-autocast features, so the path is opt-in
(``cli extract-features --weight-quant int8``).
"""

from __future__ import annotations

import torch


def _is_quantizable(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.dim() >= 2


def _scale(w: torch.Tensor) -> torch.Tensor:
    """fp32 per-output-channel scale [out, 1, ...] of a weight [out, ...]."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return amax / 127.0 + 1e-12


def quantize_state(state: dict) -> tuple[dict, dict]:
    """A state dict -> (state with each quantizable tensor as int8, {name:
    fp32 scale}); other tensors pass through (no scale entry)."""
    q_state, scales = {}, {}
    for name, t in state.items():
        if _is_quantizable(t):
            s = _scale(t)
            q_state[name] = torch.clamp(torch.round(t.detach().float() / s), -127, 127
                                        ).to(torch.int8)
            scales[name] = s
        else:
            q_state[name] = t
    return q_state, scales


def dequantize_state(q_state: dict, scales: dict, dtype=torch.bfloat16) -> dict:
    """The inverse of ``quantize_state``: int8 * scale -> ``dtype`` for each
    tensor with a scale; the rest as they are."""
    return {name: (t.float() * scales[name]).to(dtype) if name in scales else t
            for name, t in q_state.items()}


def quantization_error(state: dict, dtype=torch.bfloat16) -> dict:
    """{name: max |w - dequant(quant(w))| / (max |w| + 1e-12)} over the
    quantizable tensors: a quick check of the round trip (about 1/255 per
    channel for well-behaved weights)."""
    q, s = quantize_state(state)
    deq = dequantize_state(q, s, dtype)
    errs = {}
    for name in s:
        a, b = state[name].detach().float(), deq[name].float()
        errs[name] = float((a - b).abs().max() / (a.abs().max() + 1e-12))
    return errs
