"""Fused training forward for the MiT-EVP backbone.

Port of ``surgical_tpu/models/mit_train.py::fused_train_forward``: the
training graph over a port ``MiTEVP`` in which every frozen MiT block runs
as ``kernels.mit_block.fused_mit_block_train`` in both directions (the
train-forward kernel, then the MLP-backward and attention-backward kernels
in autograd's backward). What the reference recipe trains (prompt generator,
flow encoder, cross-attention fusions, head; train_evp.py:379-382) stays in
plain differentiable PyTorch ops, so its gradients are autograd's; the
frozen trunk passes only input gradients through.

Train-mode semantics of the flax model, reproduced as the JAX graph does:
- per-sample stochastic depth on both branches of every block, rate ramp
  ``linspace(0, drop_path_rate, sum(depths))``, factors {0, 1/keep};
- BatchNorm from batch statistics (biased variance, E[x^2] - E[x]^2) with
  running statistics updated at flax's momentum 0.99, in the flow encoder
  and the head's fuse BN;
- channel dropout on the head map before the pool.
The train-mode BatchNorm and dropout are ``_ops.bn_train`` / ``_ops.dropout``
inside the flow encoder's and the head's forwards, which the flax graph
(``MiTEVP.graph_forward``) calls too. The default prompt configuration only,
without block dropout (``cfg.drop_rate`` 0), as the kernels compute; a model
without flow skips the flow branch.

Randomness comes from an explicit ``torch.Generator``, or the masks are
given (``masks=``), so that a test can inject the JAX-drawn ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from surgical_tpu_torch.kernels.mit_block import block_weights_from_params, fused_mit_block_train
from surgical_tpu_torch.models import _ops
from surgical_tpu_torch.models.mit_fused import _check_supported


def droppath_rates(cfg) -> list[float]:
    """Per-block DropPath rate, blocks in order over the four stages."""
    return [float(r) for r in np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))]


def draw_masks(cfg, head_cfg, batch: int, generator: torch.Generator) -> dict:
    """{"droppath": [(m1, m2) per block], "dropout": [B, E] bool keep mask or
    None}: per-sample DropPath factors {0, 1/keep} (fp32; ones where the
    rate is 0) and the head's channel-dropout keep mask, on the generator's
    device."""
    dev = generator.device
    dp = []
    for rate in droppath_rates(cfg):
        if rate == 0.0:
            ones = torch.ones(batch, device=dev)
            dp.append((ones, ones))
            continue
        keep = 1.0 - rate
        dp.append(tuple((torch.rand(batch, generator=generator, device=dev) < keep).float() / keep
                        for _ in range(2)))
    drop = None
    if head_cfg.dropout > 0.0:
        drop = torch.rand(batch, head_cfg.embedding_dim, generator=generator,
                          device=dev) < 1.0 - head_cfg.dropout
    return {"droppath": dp, "dropout": drop}


def train_block_weights(model, dtype) -> dict:
    """{stage: [kernel weight dict per block]}, cached on ``model`` until a
    trunk block parameter is replaced or written (the trainable parameters,
    which change every step, are not part of the key)."""
    blocks = [b for s in range(1, 5) for b in getattr(model, f"block{s}")]
    key = (dtype, tuple((p.data_ptr(), p._version) for b in blocks for p in b.parameters()))
    cached = model.__dict__.get("_train_block_weights")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            weights = {s: [block_weights_from_params(b, dtype)
                           for b in getattr(model, f"block{s}")] for s in range(1, 5)}
        cached = model.__dict__["_train_block_weights"] = (key, weights)
    return cached[1]


def write_bn_stats(model, stats: dict) -> None:
    """Copy the running statistics that ``fused_train_forward`` or
    ``MiTEVP.graph_forward(train=True)`` returned into the BatchNorm buffers
    of ``model``."""
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            bn = model.get_submodule(name)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


def fused_train_forward(model, images, segmaps, flow, *, generator=None, masks=None,
                        dtype=torch.bfloat16, bn_group=None):
    """One training forward: (phase logits [B, 7] fp32, anticipation [B, 7]
    fp32, new BN statistics {module name: (running_mean, running_var)}).

    images, segmaps [B, H, W, 3], flow [B, H, W, 2] or None (any float dtype;
    cast to ``dtype``). The DropPath and dropout masks come from ``masks``
    (``draw_masks``'s layout) or are drawn from ``generator``. BatchNorm
    takes its statistics over the process group ``bn_group`` when one is
    given (``_ops.bn_train``)."""
    cfg, head_cfg = model.cfg, model.head_cfg
    _check_supported(cfg)
    if cfg.drop_rate > 0.0:
        raise NotImplementedError("the train kernels apply no block dropout (drop_rate="
                                  f"{cfg.drop_rate}): use the flax graph")
    dt = dtype
    x = images.to(dt)
    B = x.shape[0]
    if masks is None:
        if generator is None and (cfg.drop_path_rate > 0 or head_cfg.dropout > 0):
            raise ValueError("fused_train_forward needs a generator or masks for DropPath "
                             "and dropout")
        masks = draw_masks(cfg, head_cfg, B, generator or torch.Generator())
    dp = [(m1.to(x.device, torch.float32).contiguous(), m2.to(x.device, torch.float32).contiguous())
          for m1, m2 in masks["droppath"]]

    pg = model.prompt_generator
    hand = pg.init_prompts(segmaps.to(dt))
    kw = train_block_weights(model, dt)

    cur = 0
    grids = []
    for si in range(4):
        stage = si + 1
        x, H, W = getattr(model, f"patch_embed{stage}")(x)
        C = x.shape[-1]
        heads, sr = cfg.num_heads[si], cfg.sr_ratios[si]
        base = hand[stage] + _ops.dense(x, getattr(pg, f"embedding_generator{stage}"))
        shared = getattr(pg, f"shared_mlp{stage}")
        for d, blk in enumerate(getattr(model, f"block{stage}")):
            lw = getattr(pg, f"lightweight_mlp{stage}_{d}")[0]
            feat = F.gelu(_ops.dense(base, lw).float()).to(dt)  # exact-erf GELU
            x = x + _ops.dense(feat, shared)
            xln = _ops.layernorm(x, blk.norm1)
            kv_in = xln
            if sr > 1:
                red = _ops.conv(xln.reshape(B, H, W, C), blk.attn.sr, sr, 0)
                kv_in = _ops.layernorm(red.reshape(B, -1, C), blk.attn.norm)
            kv = _ops.dense(kv_in, blk.attn.kv)
            m1, m2 = dp[cur + d]
            x = fused_mit_block_train(x.contiguous(), xln.contiguous(),
                                      kv[..., :C].contiguous(), kv[..., C:].contiguous(),
                                      kw[stage][d], m1, m2, heads=heads, H=H, W=W)
        cur += cfg.depths[si]
        x = _ops.layernorm(x, getattr(model, f"norm{stage}"))
        grids.append(x.reshape(B, H, W, C))
        x = grids[-1]

    stats = {}
    if cfg.with_flow and flow is not None:
        fs = {}
        f3, f4 = model.flow_encoder(flow.to(dt), _ops.FUSED, fs, bn_group)
        stats.update({f"flow_encoder.{k}": v for k, v in fs.items()})
        for idx, ca, ft in ((2, model.cross_attn_s3, f3), (3, model.cross_attn_s4, f4)):
            g = grids[idx]
            grids[idx] = ca(g.reshape(B, -1, g.shape[-1]), ft).reshape(g.shape)

    hs = {}
    y, y_ant = model.head(grids, return_features=False, bn_stats=hs,
                          keep=masks["dropout"] if head_cfg.dropout > 0.0 else None,
                          bn_group=bn_group)
    stats.update({f"head.{k}": v for k, v in hs.items()})
    return y, y_ant, stats
