"""Trans-SVNet-style refinement transformer.

Port of ``surgical_tpu/models/transsv.py`` in the key names that the JAX
package's ``export_refiner_state_dict`` writes (the public Trans-SVNet
layout): ``fc``, ``transformer.encoder.layers.{i}.enc_self_attn`` /
``pos_ffn``, ``transformer.decoder.layers.{i}.dec_self_attn`` /
``dec_enc_attn`` / ``pos_ffn``; attention projections ``W_Q/W_K/W_V/fc`` and
FFN linears without bias, LayerNorms inline (no parameters, eps 1e-6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import RefinerConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.models.mstcn import torch_like_uniform_

LN_EPS = 1e-6


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

    def forward(self, q_in, k_in, v_in):  # [B, Lq, d], [B, Lk, d], [B, Lk, d]
        B, Lq, d = q_in.shape
        Lk = k_in.shape[1]
        H = self.n_heads
        q = self.W_Q(q_in).reshape(B, Lq, H, self.d_k).transpose(1, 2)
        k = self.W_K(k_in).reshape(B, Lk, H, self.d_k).transpose(1, 2)
        v = self.W_V(v_in).reshape(B, Lk, H, self.d_v).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k)
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, Lq, -1)
        return F.layer_norm(q_in + self.fc(ctx), (d,), eps=LN_EPS)


class PoswiseFeedForwardNet(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(d_model, d_ff, bias=False), nn.ReLU(),
                                nn.Linear(d_ff, d_model, bias=False))

    def forward(self, x):
        return F.layer_norm(x + self.fc(x), (x.shape[-1],), eps=LN_EPS)


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
        torch_like_uniform_(self, torch.Generator().manual_seed(seed))
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
