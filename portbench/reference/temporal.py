"""Plain fp32 references of the temporal models and of their composition.

- MS-TCN (TeCNO, arXiv:2003.10751): stages of causal dilated residual
  layers; each later stage reads the softmax of the stage before.
- Causal Mamba (arXiv:2312.00752): in-projection, blocks of (in_proj to x
  and z, causal depthwise conv and SiLU, x_proj to dt, B, C, softplus dt,
  the selective scan run step by step in fp32, gate SiLU(z), out_proj) with
  residual adds, LayerNorm (eps 1e-6), head.
- The Trans-SVNet refiner (arXiv:2103.09712): each frame's zero-left-padded
  window of the last ``len_q`` temporal outputs is encoded, and the frame's
  tanh-projected feature decodes against it (post-LN attention blocks).
- ``pipeline``: temporal model, its last stage, the refiner; the models are
  causal, so this is also what a stream of single frames must produce.

State dicts are in the reference checkpoints' key names; configurations are
the benchmark's JSON dicts. Nothing of the program is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _conv1d(x, sd, name, dilation=1, left=0):
    """x [T, C_in] -> [T, C_out], causal: ``left`` zero frames in front."""
    y = F.conv1d(F.pad(x.t()[None], (left, 0)), sd[name + ".weight"], sd[name + ".bias"],
                 dilation=dilation)
    return y[0].t()


def mstcn(sd, cfg, feats):
    """feats [T, f_dim] -> [stages, T, out_features]."""
    outs, x = [], feats
    names = ["stage1_phase"] + [f"stages.{s}" for s in range(cfg["stages"] - 1)]
    for si, p in enumerate(names):
        if si:
            x = torch.softmax(outs[-1], dim=-1)
        h = _conv1d(x, sd, p + ".conv_1x1")
        for i in range(cfg["layers"]):
            d = 2 ** i
            c = torch.relu(_conv1d(h, sd, f"{p}.layers.{i}.conv_dilated", d, 2 * d))
            h = h + _conv1d(c, sd, f"{p}.layers.{i}.conv_1x1")
        outs.append(_conv1d(h, sd, p + ".conv_out_classes"))
    return torch.stack(outs)


def selective_scan(x, dt, A, B, C, D):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t + D x_t,
    step by step in fp32 from a zero state: x, dt [V, T, d], A [d, N], B, C
    [V, T, N] -> y [V, T, d]."""
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * B[:, :, None, :]
    hs = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(x.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h, out=hs[:, t])
    return torch.einsum("vtdn,vtn->vtd", hs, C) + D * x


def mamba(sd, cfg, feats):
    """feats [V, T, f_dim] (videos padded at their ends; every step is
    causal) -> [V, T, out_features]."""
    d_in, n = cfg["expand"] * cfg["d_model"], cfg["d_state"]
    r = cfg["dt_rank"] or -(-cfg["d_model"] // 16)
    k = cfg["d_conv"]
    h = F.linear(feats, sd["in_proj.weight"], sd["in_proj.bias"])
    for i in range(cfg["layers"]):
        p = f"blocks.{i}."
        x, z = F.linear(h, sd[p + "in_proj.weight"]).chunk(2, dim=-1)
        w = sd[p + "conv1d.weight"]  # [d_in, 1, k]
        xc = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w, sd[p + "conv1d.bias"],
                      groups=d_in).transpose(1, 2)
        xc = F.silu(xc)
        dt, Bm, Cm = F.linear(xc, sd[p + "x_proj.weight"]).split([r, n, n], dim=-1)
        dt = F.softplus(F.linear(dt, sd[p + "dt_proj.weight"], sd[p + "dt_proj.bias"]))
        y = selective_scan(xc, dt, -torch.exp(sd[p + "A_log"]), Bm, Cm, sd[p + "D"])
        h = h + F.linear(y * F.silu(z), sd[p + "out_proj.weight"])
    h = F.layer_norm(h, (h.shape[-1],), sd["norm.weight"], sd["norm.bias"], LN_EPS)
    return F.linear(h, sd["head.weight"], sd["head.bias"])


def _mha(sd, p, q_in, kv_in, heads, d_k):
    """Post-LN multi-head attention with residual, bias-free projections."""
    Bn, Lq, _ = q_in.shape
    Lk = kv_in.shape[1]
    q = F.linear(q_in, sd[p + "W_Q.weight"]).reshape(Bn, Lq, heads, d_k).transpose(1, 2)
    k = F.linear(kv_in, sd[p + "W_K.weight"]).reshape(Bn, Lk, heads, d_k).transpose(1, 2)
    v = F.linear(kv_in, sd[p + "W_V.weight"]).reshape(Bn, Lk, heads, d_k).transpose(1, 2)
    ctx = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d_k), -1) @ v
    out = q_in + F.linear(ctx.transpose(1, 2).reshape(Bn, Lq, -1), sd[p + "fc.weight"])
    return F.layer_norm(out, (out.shape[-1],), sd[p + "layernorm.weight"],
                        sd[p + "layernorm.bias"], LN_EPS)


def _ffn(sd, p, x):
    h = F.linear(torch.relu(F.linear(x, sd[p + "fc.0.weight"], sd[p + "fc.0.bias"])),
                 sd[p + "fc.2.weight"], sd[p + "fc.2.bias"])
    return F.layer_norm(x + h, (x.shape[-1],), sd[p + "layernorm.weight"],
                        sd[p + "layernorm.bias"], LN_EPS)


def refiner(sd, cfg, temporal_out, feats):
    """temporal_out [T, out], feats [T, f_dim] -> refined [T, out]."""
    L, heads, d_k = cfg["len_q"], cfg["n_heads"], min(64, cfg["f_maps"])
    T = temporal_out.shape[0]
    padded = F.pad(temporal_out, (0, 0, L - 1, 0))
    idx = torch.arange(T, device=feats.device)[:, None] + torch.arange(L, device=feats.device)
    enc = padded[idx]  # [T, L, out]
    for i in range(cfg["n_layers"]):
        p = f"transformer.encoder.layers.{i}."
        enc = _ffn(sd, p + "pos_ffn.", _mha(sd, p + "enc_self_attn.", enc, enc, heads, d_k))
    dec = torch.tanh(F.linear(feats, sd["fc.weight"]))[:, None, :]
    for i in range(cfg["n_layers"]):
        p = f"transformer.decoder.layers.{i}."
        dec = _mha(sd, p + "dec_self_attn.", dec, dec, heads, d_k)
        dec = _ffn(sd, p + "pos_ffn.", _mha(sd, p + "dec_enc_attn.", dec, enc, heads, d_k))
    return dec[:, 0]


def pipeline(kind, sd_t, cfg_t, sd_r, cfg_r, feats):
    """One video's features [T, f_dim] -> refined outputs [T, out]: the
    temporal model (``kind`` "mstcn" or "mamba"), its last stage, the
    refiner."""
    g = mstcn(sd_t, cfg_t, feats)[-1] if kind == "mstcn" else mamba(sd_t, cfg_t, feats[None])[0]
    return refiner(sd_r, cfg_r, g, feats)
