"""Jamba as the temporal model: a hybrid stack of Mamba-1 mixers and causal
multi-query attention, each followed by a SwiGLU MLP.

The layers follow HF ``modeling_jamba`` (``JambaMambaDecoderLayer``,
``JambaAttentionDecoderLayer``, ``JambaMLP``) in its key names, so that
AI21's decoder layers load as they are: ``layers.{i}.input_layernorm``, the
mixer (``layers.{i}.mamba.*``: ``models/mamba.py::MambaBlock`` with its dt, B
and C RMSNorms; or ``layers.{i}.self_attn.{q,k,v,o}_proj``),
``layers.{i}.pre_ff_layernorm``, ``layers.{i}.feed_forward.{gate,up,down}_proj``,
``final_layernorm``. Where the language model embeds tokens and ends in its
LM head, this model projects the per-frame features (``in_proj``, f_dim ->
hidden, with bias, as ``CausalMambaModel``) and ends in ``head`` (hidden ->
out_features, with bias).

A layer: ``h + mixer(input_layernorm(h))``, then ``h + mlp(pre_ff_layernorm(h))``.
Layer i is attention where ``i % attn_layer_period == attn_layer_offset``
(HF ``layers_block_type``), else Mamba. The attention is causal, without a
positional encoding (Jamba's Mamba layers carry the order), scaled by
1/sqrt(head_dim), its key and value heads shared by ``num_attention_heads /
num_key_value_heads`` query heads each (``scaled_dot_product_attention``,
its softmax in fp32). Products and activations run in ``cfg.dtype``; the
RMSNorms, the scan, A = -exp(A_log) and D in fp32 (HF Jamba and
``mamba_ssm``), and, as ``mamba_ssm`` runs a Mamba stack (``residual_in_fp32``,
its fused add-norm and its conv and scan kernels, which the published config's
``use_mamba_kernels`` selects), the residual stream, the mixers' conv, dt's
softplus and the gate in fp32. The scan is called through the module attribute
``kernels.selective_scan.selective_scan``, as ``MambaBlock`` calls it.

Spans (``utils/trace.py``): ``jamba.mamba`` or ``jamba.attention`` around each
layer's norm, mixer and residual add, ``jamba.mlp`` around its MLP half;
``COUNTS`` (``counters()["jamba"]``): offline forward calls and frames, and
the streaming steps of ``serving/online.py::OnlineJamba`` with its K/V
cache's capacity and the longest stream it has held.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import JambaConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.models.mamba import MambaBlock, RMSNorm, _dt_bias_
from surgical_tpu_torch.models.mstcn import DropoutMasks, torch_like_uniform_
from surgical_tpu_torch.utils.trace import span

COUNTS = {"forwards": 0, "frames": 0, "steps": 0, "kv_capacity": 0, "kv_high_water": 0}


class JambaAttention(nn.Module):
    """Causal multi-query attention, bias-free projections."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        self.heads, self.kv_heads, self.head_dim = (cfg.num_attention_heads,
                                                    cfg.num_key_value_heads, cfg.head_dim)
        H = cfg.hidden_size
        self.q_proj = nn.Linear(H, self.heads * self.head_dim, bias=False)
        self.k_proj = nn.Linear(H, self.kv_heads * self.head_dim, bias=False)
        self.v_proj = nn.Linear(H, self.kv_heads * self.head_dim, bias=False)
        self.o_proj = nn.Linear(self.heads * self.head_dim, H, bias=False)

    def forward(self, x):
        """x [B, T, hidden] -> [B, T, hidden]."""
        B, T, _ = x.shape
        split = lambda t, n: t.view(B, T, n, self.head_dim).transpose(1, 2)
        q = split(self.q_proj(x), self.heads)
        k, v = split(self.k_proj(x), self.kv_heads), split(self.v_proj(x), self.kv_heads)
        ctx = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=self.kv_heads != self.heads)
        return self.o_proj(ctx.transpose(1, 2).reshape(B, T, -1))


class JambaMLP(nn.Module):
    """SwiGLU: down_proj(silu(gate_proj(x)) * up_proj(x)), bias-free."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(H, I, bias=False)
        self.up_proj = nn.Linear(H, I, bias=False)
        self.down_proj = nn.Linear(I, H, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class JambaLayer(nn.Module):
    """One decoder layer of ``kind`` "mamba" or "attention"."""

    def __init__(self, cfg: JambaConfig, kind: str):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if kind == "attention":
            self.self_attn = JambaAttention(cfg)
        else:
            self.mamba = MambaBlock(cfg.mamba(), ssm_norm_eps=cfg.rms_norm_eps)
        self.pre_ff_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.feed_forward = JambaMLP(cfg)

    @property
    def mixer(self) -> nn.Module:
        return self.self_attn if self.kind == "attention" else self.mamba

    def mlp(self, h):
        """The MLP half with its residual add."""
        with span("jamba.mlp"):
            return h + self.feed_forward(self.pre_ff_layernorm(h))

    def forward(self, h):
        with span("jamba." + self.kind):
            h = h + self.mixer(self.input_layernorm(h))
        return self.mlp(h)


class JambaTemporalModel(nn.Module):
    """[B, T, f_dim] -> [1, B, T, out_features] in fp32 (a singleton stage
    axis, as ``CausalMambaModel``, so callers keep ``outputs[-1]``). The
    input is cast to ``cfg.dtype``. ``masks`` is accepted for the trainer's
    call and unused: Jamba has no dropout."""

    def __init__(self, cfg: JambaConfig = JambaConfig(), *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.in_proj = nn.Linear(cfg.f_dim, cfg.hidden_size)
        self.layers = nn.ModuleList(JambaLayer(cfg, kind) for kind in cfg.layer_types)
        self.final_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.head = nn.Linear(cfg.hidden_size, cfg.out_features)
        g = torch.Generator().manual_seed(seed)
        torch_like_uniform_(self, g)
        with torch.no_grad():
            for layer in self.layers:
                if layer.kind == "mamba":
                    _dt_bias_(layer.mamba.dt_proj.bias, g)
        self.eval()
        self.to(device=device, dtype=getattr(torch, cfg.dtype))

    @property
    def dtype(self) -> torch.dtype:
        return self.in_proj.weight.dtype

    def forward(self, x, masks: DropoutMasks | None = None):
        COUNTS["forwards"] += 1
        COUNTS["frames"] += x.shape[0] * x.shape[1]
        h = self.in_proj(x.to(self.dtype)).float()  # the residual stream in fp32
        for layer in self.layers:
            h = layer(h)
        return self.head(self.final_layernorm(h)).float()[None]
