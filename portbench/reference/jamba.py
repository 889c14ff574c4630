"""Plain fp32 reference of Jamba as the temporal model.

HF ``modeling_jamba``'s equations written out (AI21-Jamba2-3B: 28 layers,
attention where ``i % attn_layer_period == attn_layer_offset``, else Mamba;
a SwiGLU MLP after every mixer, ``num_experts`` 1):

- RMSNorm: x / sqrt(mean(x^2) + eps) * weight (``JambaRMSNorm``);
- a layer: h + mixer(input_layernorm(h)), then h + mlp(pre_ff_layernorm(h));
- the Mamba mixer (``JambaMambaMixer``'s slow path): in_proj to x and z, the
  causal depthwise conv (``F.conv1d`` over d_conv - 1 frames of left zero
  padding, with bias) and SiLU on x, x_proj to dt, B, C, RMSNorms on each
  (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``), dt = softplus(dt_proj(dt)),
  the selective scan from a zero state with A = -exp(A_log) and D (the
  ``scan`` the caller passes: ``reference/temporal.py::selective_scan``,
  step by step), the gate SiLU(z), out_proj;
- attention (``JambaAttention``, eager): q, k, v projections without bias,
  each key and value head shared by its group of query heads, no positional
  encoding, scores / sqrt(head_dim), a causal mask, the softmax in fp32,
  o_proj;
- the MLP: down_proj(SiLU(gate_proj(x)) * up_proj(x)).

Departures from HF, for the temporal stage: the token embedding is a
projection of the per-frame features (``in_proj``, with bias) and the LM head
is ``head`` (hidden -> 7 phase logits and 7 anticipations, with bias), after
``final_layernorm``. ``traffic/hybrid_video.py::pipeline`` composes it with
the refiner's reference.

Every tensor is computed in fp32 (with TF32 off, ``compare.precision``); the
state dict may hold bf16 weights (the published precision), which are read
as fp32. ``quant``, when given, is applied to both operands of every product
(the control's fp8). The count of products (``work.count_flops``, which
counts no elementwise work) passes ``skip_scan``, which skips the scan's
step-by-step loop. Nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _q(x, quant):
    return x if quant is None else quant(x)


def _w(sd, name):
    return sd[name].float()


def linear(x, sd, name, quant=None, bias=False):
    b = _w(sd, name + ".bias") if bias else None
    return F.linear(_q(x, quant), _q(_w(sd, name + ".weight"), quant), b)


def rms_norm(x, sd, name, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _w(sd, name + ".weight")


def layer_types(cfg) -> list[str]:
    return ["attention" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba"
            for i in range(cfg["num_hidden_layers"])]


def mamba_mixer(x, sd, p, cfg, scan, quant=None):
    """x [V, T, hidden] -> [V, T, hidden]."""
    n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    eps = cfg["rms_norm_eps"]
    xs, z = linear(x, sd, p + "in_proj", quant).chunk(2, dim=-1)
    d_in = xs.shape[-1]
    xc = F.conv1d(F.pad(xs.transpose(1, 2), (k - 1, 0)), _w(sd, p + "conv1d.weight"),
                  _w(sd, p + "conv1d.bias"), groups=d_in).transpose(1, 2)
    xc = F.silu(xc)
    dt, Bm, Cm = linear(xc, sd, p + "x_proj", quant).split([r, n, n], dim=-1)
    dt = rms_norm(dt, sd, p + "dt_layernorm", eps)
    Bm = rms_norm(Bm, sd, p + "b_layernorm", eps)
    Cm = rms_norm(Cm, sd, p + "c_layernorm", eps)
    dt = F.softplus(linear(dt, sd, p + "dt_proj", quant, bias=True))
    y = scan(xc, dt, -torch.exp(_w(sd, p + "A_log")), Bm, Cm, _w(sd, p + "D"))
    return linear(y * F.silu(z), sd, p + "out_proj", quant)


def attention(x, sd, p, cfg, quant=None):
    """x [V, T, hidden] -> [V, T, hidden]: causal attention, each key and
    value head repeated for its group of query heads."""
    V, T, _ = x.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // heads
    split = lambda t, h: t.view(V, T, h, hd).transpose(1, 2)
    q = split(linear(x, sd, p + "q_proj", quant), heads)
    k = split(linear(x, sd, p + "k_proj", quant), kv).repeat_interleave(heads // kv, dim=1)
    v = split(linear(x, sd, p + "v_proj", quant), kv).repeat_interleave(heads // kv, dim=1)
    s = _q(q, quant) @ _q(k, quant).transpose(-1, -2) / math.sqrt(hd)
    future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(future, float("-inf"))
    w = torch.softmax(s, dim=-1, dtype=torch.float32)
    ctx = (_q(w, quant) @ _q(v, quant)).transpose(1, 2).reshape(V, T, heads * hd)
    return linear(ctx, sd, p + "o_proj", quant)


def mlp(x, sd, p, quant=None):
    g = linear(x, sd, p + "gate_proj", quant)
    return linear(F.silu(g) * linear(x, sd, p + "up_proj", quant), sd, p + "down_proj", quant)


def forward(sd, cfg, feats, scan, quant=None):
    """feats [V, T, f_dim] -> [V, T, out_features]."""
    eps = cfg["rms_norm_eps"]
    h = linear(feats.float(), sd, "in_proj", quant, bias=True)
    for i, kind in enumerate(layer_types(cfg)):
        p = f"layers.{i}."
        x = rms_norm(h, sd, p + "input_layernorm", eps)
        if kind == "attention":
            h = h + attention(x, sd, p + "self_attn.", cfg, quant)
        else:
            h = h + mamba_mixer(x, sd, p + "mamba.", cfg, scan, quant)
        h = h + mlp(rms_norm(h, sd, p + "pre_ff_layernorm", eps), sd, p + "feed_forward.", quant)
    return linear(rms_norm(h, sd, "final_layernorm", eps), sd, "head", quant, bias=True)


def skip_scan(x, dt, A, B, C, D):
    """The scan's shape without its loop, for ``work.count_flops``."""
    return x
