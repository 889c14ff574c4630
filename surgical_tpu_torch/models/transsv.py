"""Trans-SVNet-style refinement transformer, and the prompt ``Adaptor``.

Port of ``surgical_tpu/models/transsv.py`` with JAX's parameter set, in the
key names of the public Trans-SVNet layout that the JAX package's
``export_refiner_state_dict`` writes: ``fc``,
``transformer.encoder.layers.{i}.enc_self_attn`` / ``pos_ffn``,
``transformer.decoder.layers.{i}.dec_self_attn`` / ``dec_enc_attn`` /
``pos_ffn``; attention projections ``W_Q/W_K/W_V/fc`` without bias. As in
JAX (``nn.Dense`` with bias, ``nn.LayerNorm``), the FFN's linears carry a
bias (``pos_ffn.fc.0.bias``, ``pos_ffn.fc.2.bias``) and every attention
block and FFN ends in a LayerNorm with scale and bias (``layernorm``, eps
1e-6), the key JAX's importer reads (``surgical_tpu/models/convert.py``,
``_attn_import`` / ``_ffn_import``). The reference's own layout has inline
LayerNorms and bias-free linears: loading such a state dict (or a port
checkpoint written before these parameters) fills identity scales and zero
biases where the keys are missing, logs which, and is strict about every
other key.
"""

from __future__ import annotations

import logging
import math

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import RefinerConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.models.mstcn import torch_like_uniform_

LN_EPS = 1e-6

logger = logging.getLogger(__name__)


def causal_windows(x, len_q: int):
    """Zero-left-padded causal sliding windows: x [T, C] -> [T, len_q, C]
    with out[t, j] = x[t - len_q + 1 + j] (zeros where the index is < 0)."""
    padded = F.pad(x, (0, 0, len_q - 1, 0))
    return padded.unfold(0, len_q, 1).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head attention with residual; head dims d_k/d_v
    decoupled from d_model."""

    def __init__(self, d_model: int, d_k: int, d_v: int, n_heads: int):
        super().__init__()
        self.d_k, self.d_v, self.n_heads = d_k, d_v, n_heads
        self.W_Q = nn.Linear(d_model, n_heads * d_k, bias=False)
        self.W_K = nn.Linear(d_model, n_heads * d_k, bias=False)
        self.W_V = nn.Linear(d_model, n_heads * d_v, bias=False)
        self.fc = nn.Linear(n_heads * d_v, d_model, bias=False)
        self.layernorm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, q_in, k_in, v_in):  # [B, Lq, d], [B, Lk, d], [B, Lk, d]
        B, Lq, d = q_in.shape
        Lk = k_in.shape[1]
        H = self.n_heads
        q = self.W_Q(q_in).reshape(B, Lq, H, self.d_k).transpose(1, 2)
        k = self.W_K(k_in).reshape(B, Lk, H, self.d_k).transpose(1, 2)
        v = self.W_V(v_in).reshape(B, Lk, H, self.d_v).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k)
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, Lq, -1)
        return self.layernorm(q_in + self.fc(ctx))


class PoswiseFeedForwardNet(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(d_model, d_ff), nn.ReLU(), nn.Linear(d_ff, d_model))
        self.layernorm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        return self.layernorm(x + self.fc(x))


def _fill_reference_layout(module, state_dict, prefix, *_):
    """Load pre-hook of ``RefinementTransformer``: a state dict in the
    reference's layout (no ``layernorm`` keys, bias-free FFN linears) gets
    identity LayerNorms and zero FFN biases, as JAX's importer fills them;
    the filled keys are logged. Keys present are left as they are, and a
    block whose weights are absent is left to the strict load to report."""
    filled = []
    for name, m in module.named_modules():
        if not isinstance(m, (MultiHeadAttention, PoswiseFeedForwardNet)):
            continue
        pre = f"{prefix}{name}."
        anchor = "W_Q.weight" if isinstance(m, MultiHeadAttention) else "fc.0.weight"
        if pre + anchor not in state_dict:
            continue
        defaults = {"layernorm.weight": m.layernorm.weight, "layernorm.bias": m.layernorm.bias}
        if isinstance(m, PoswiseFeedForwardNet):
            defaults.update({"fc.0.bias": m.fc[0].bias, "fc.2.bias": m.fc[2].bias})
        for key, param in defaults.items():
            if pre + key not in state_dict:
                fill = torch.ones_like if key == "layernorm.weight" else torch.zeros_like
                state_dict[pre + key] = fill(param.detach())
                filled.append(pre + key)
    if filled:
        logger.info("RefinementTransformer: filled %d keys absent from the state dict with "
                    "identity LayerNorms and zero FFN biases: %s", len(filled), ", ".join(filled))


class EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, d_k, d_v, n_heads):
        super().__init__()
        self.enc_self_attn = MultiHeadAttention(d_model, d_k, d_v, n_heads)
        self.pos_ffn = PoswiseFeedForwardNet(d_model, d_ff)

    def forward(self, x):
        return self.pos_ffn(self.enc_self_attn(x, x, x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, d_k, d_v, n_heads):
        super().__init__()
        self.dec_self_attn = MultiHeadAttention(d_model, d_k, d_v, n_heads)
        self.dec_enc_attn = MultiHeadAttention(d_model, d_k, d_v, n_heads)
        self.pos_ffn = PoswiseFeedForwardNet(d_model, d_ff)

    def forward(self, dec, enc):
        dec = self.dec_self_attn(dec, dec, dec)
        return self.pos_ffn(self.dec_enc_attn(dec, enc, enc))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer231(nn.Module):
    """Encode the temporal-logit window, decode the spatial embedding
    against it: inputs [T, len_q, d] + feas [T, 1, d] -> [T, 1, d]."""

    def __init__(self, d_model, d_ff, d_k, d_v, n_layers, n_heads):
        super().__init__()
        self.encoder = _Stack(EncoderLayer(d_model, d_ff, d_k, d_v, n_heads)
                              for _ in range(n_layers))
        self.decoder = _Stack(DecoderLayer(d_model, d_ff, d_k, d_v, n_heads)
                              for _ in range(n_layers))

    def forward(self, inputs, feas):
        enc = inputs
        for layer in self.encoder.layers:
            enc = layer(enc)
        dec = feas
        for layer in self.decoder.layers:
            dec = layer(dec, enc)
        return dec


class Adaptor(nn.Module):
    """Prompt adaptor for LFB / temporal features (the reference's
    ``Adaptor``, adapter_transformer.py:241-288, which its forward leaves
    commented out; an opt-in module here as in JAX): ``lightweight_mlp``
    (embed_dim -> embed_dim / scale_factor), exact-erf GELU, ``shared_mlp``
    (back to embed_dim), both ``nn.Linear`` with bias.

    ``lt_mode=True``: x, prompt [T, embed_dim] -> x + mlp(prompt).
    ``lt_mode=False``: x, prompt [T, len_q, num_classes] flattened per frame
    (so embed_dim = len_q * num_classes) -> [T, len_q, num_classes]."""

    def __init__(self, embed_dim: int, scale_factor: int = 4, len_q: int = 30,
                 num_classes: int = 14, *, seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.len_q, self.num_classes = len_q, num_classes
        self.lightweight_mlp = nn.Linear(embed_dim, embed_dim // scale_factor)
        self.shared_mlp = nn.Linear(embed_dim // scale_factor, embed_dim)
        torch_like_uniform_(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    def forward(self, x, prompt, lt_mode: bool = True):
        mlp = lambda p: self.shared_mlp(F.gelu(self.lightweight_mlp(p)))
        if lt_mode:
            return x + mlp(prompt)
        T = x.shape[0]
        return (x.reshape(T, -1) + mlp(prompt.reshape(T, -1))).reshape(
            T, self.len_q, self.num_classes)


def _init_like_flax_(module: nn.Module, g: torch.Generator) -> None:
    """The JAX refiner's init: every linear weight U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) from ``g`` (``torch_like_uniform``), biases zero and
    LayerNorms identity (flax's defaults). The weights take the draws the
    reference layout's bias-free linears took."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = m.weight.shape[1] ** -0.5
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


class RefinementTransformer(nn.Module):
    """forward(temporal_logits [T, out_features], lfb [T, f_dim])
    -> refined logits [T, out_features]."""

    def __init__(self, cfg: RefinerConfig = RefinerConfig(), *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.fc = nn.Linear(cfg.f_dim, cfg.out_features, bias=False)
        self.transformer = Transformer231(cfg.out_features, cfg.f_maps, cfg.d_k, cfg.d_k,
                                          cfg.n_layers, cfg.n_heads)
        _init_like_flax_(self, torch.Generator().manual_seed(seed))
        self.register_load_state_dict_pre_hook(_fill_reference_layout)
        self.eval()
        self.to(device)

    def forward(self, temporal_logits, lfb):
        windows = causal_windows(temporal_logits, self.cfg.len_q)
        feas = torch.tanh(self.fc(lfb))[:, None, :]
        return self.transformer(windows, feas)[:, 0, :]

    def refine_window(self, window, lfb_t):
        """Streaming form: one zero-left-padded causal window [len_q,
        out_features] + this frame's LFB feature [f_dim] -> refined logits
        [out_features]."""
        feas = torch.tanh(self.fc(lfb_t[None]))[:, None, :]
        return self.transformer(window[None], feas)[0, 0]
