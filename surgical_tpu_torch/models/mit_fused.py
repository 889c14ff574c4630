"""Fused inference forward for the MiT-EVP backbone.

Port of ``surgical_tpu/models/mit_fused.py::fused_forward``: the serving
graph in bf16 (BatchNorm from running statistics, no dropout). Every MiT
block of stages 1-3 runs the block kernel and stage 4 runs the whole-stage
kernel (``kernels.mit_block``). The patch embeds, the prompt cascade and the
prompt adds of stages 1-3 (exact-erf GELU), LN1 and the spatial-reduction /
kv path of stages 1-3, the flow encoder, the two cross-attentions and the
pooled head are plain PyTorch, as the JAX package leaves them to XLA.

The JAX module's TPU routing tables (stage fusion, batch tiles, VMEM
sizing, prompt folding, lane packing) encode TPU measurements and have no
counterpart here. The kernels' weight dicts are built once per model and
parameter state (``kernel_weights``), not per batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surgical_tpu_torch.kernels.mit_block import (
    block_weights_from_params,
    fused_mit_block,
    fused_mit_stage,
    stage_weights_from_params,
)
from surgical_tpu_torch.models import _ops


def kernel_weights(model, dtype=torch.bfloat16) -> dict:
    """{stage: [block weight dict per block]} for stages 1-3 and {4: stage
    weight dict}, in the kernels' layout. Cached on ``model``; rebuilt when a
    parameter is replaced, moved or written in place (load_state_dict)."""
    key = (dtype, tuple((p.data_ptr(), p._version) for p in model.parameters()))
    cached = model.__dict__.get("_kernel_weights")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            weights = {s: [block_weights_from_params(b, dtype)
                           for b in getattr(model, f"block{s}")] for s in (1, 2, 3)}
            weights[4] = stage_weights_from_params(model, 4, dtype)
        cached = model.__dict__["_kernel_weights"] = (key, weights)
    return cached[1]


@torch.no_grad()
def fused_forward(model, images, segmaps, flow, return_features: bool = True):
    """images, segmaps [B, H, W, 3], flow [B, H, W, 2] or None (any float
    dtype; cast to bf16) -> pooled features [B, E] fp32, or (phase logits,
    anticipation) with ``return_features=False``."""
    cfg = model.cfg
    dt = torch.bfloat16
    x = images.to(dt)
    B = x.shape[0]
    pg = model.prompt_generator
    hand = pg.init_prompts(segmaps.to(dt))
    kw = kernel_weights(model, dt)

    grids = []
    for si in range(4):
        stage = si + 1
        x, H, W = getattr(model, f"patch_embed{stage}")(x)
        C = x.shape[-1]
        heads, sr = cfg.num_heads[si], cfg.sr_ratios[si]
        base = hand[stage] + _ops.dense(x, getattr(pg, f"embedding_generator{stage}"))
        if stage == 4:
            # whole stage in one kernel call: in-kernel prompt adds (tanh
            # GELU), LN1 and kv
            x = fused_mit_stage(x.contiguous(), base.contiguous(), kw[stage],
                                heads=heads, H=H, W=W, sr=sr)
        else:
            shared = getattr(pg, f"shared_mlp{stage}")
            for d, blk in enumerate(getattr(model, f"block{stage}")):
                lw = getattr(pg, f"lightweight_mlp{stage}_{d}")[0]
                feat = F.gelu(_ops.dense(base, lw).float()).to(dt)
                x = x + _ops.dense(feat, shared)
                xln = _ops.layernorm(x, blk.norm1)
                kv_in = xln
                if sr > 1:
                    red = _ops.conv(xln.reshape(B, H, W, C), blk.attn.sr, sr, 0)
                    kv_in = _ops.layernorm(red.reshape(B, -1, C), blk.attn.norm)
                kv = _ops.dense(kv_in, blk.attn.kv)
                x = fused_mit_block(x.contiguous(), kv[..., :C].contiguous(),
                                    kv[..., C:].contiguous(),
                                    kw[stage][d],
                                    heads=heads, H=H, W=W)
        x = _ops.layernorm(x, getattr(model, f"norm{stage}"))
        grids.append(x.reshape(B, H, W, C))
        x = grids[-1]

    if flow is not None:
        f3, f4 = model.flow_encoder(flow.to(dt))
        for idx, ca, ft in ((2, model.cross_attn_s3, f3), (3, model.cross_attn_s4, f4)):
            g = grids[idx]
            grids[idx] = ca(g.reshape(B, -1, g.shape[-1]), ft).reshape(g.shape)

    return model.head(grids, return_features=return_features)
