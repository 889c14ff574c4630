"""Fused inference forward for the MiT-EVP backbone.

Port of ``surgical_tpu/models/mit_fused.py::fused_forward``: the serving
graph in bf16 (BatchNorm from running statistics, no dropout). Every MiT
block of stages 1-3 runs the block kernel, and stage 4 runs the whole-stage
kernel (``kernels.mit_block``) when the batch is a multiple of
``_FUSE_BT[4]`` = 8, as the JAX module routes it; at any other batch stage 4
runs block by block like stages 1-3. The patch embeds, the prompt cascade
and the per-block prompt adds (exact-erf GELU), LN1 and the spatial-reduction
/ kv path, the flow encoder, the two cross-attentions and the pooled head
are plain PyTorch, as the JAX package leaves them to XLA. A model without
flow fusion (``with_flow=False``) skips the flow branch, as JAX's graph
does. The kernels compute the default prompt configuration only
(``_check_supported``); the flax graph (``MiTEVP.graph_forward``) runs the
others.

The lane-packed route is mirrored with the JAX module's names and defaults
(``_ROUTE_PACKED2``, off; ``_PACKED2_ROW_CHUNKS``,
``_PACKED2_MIN_N_FOR_CHUNKING``), read at call time: when set, a block with
C = 64 and one head (stage 1 of MiT-b3) on an even batch runs the packed2
kernel instead of the block kernel. Of the JAX module's other TPU routing
tables (stage fusion, batch tiles, VMEM sizing, prompt folding) only
stage 4's batch tile is mirrored, since it picks the prompt GELU's form; the
rest encode TPU measurements and have no counterpart here. The kernels'
weight dicts are built once per model and parameter state
(``kernel_weights``), not per batch. The kernels run as ``torch.library``
custom ops (``kernels/ops.py``), so ``torch.export`` traces this graph with
them inside (``serving/export.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from surgical_tpu_torch.core.state import cached, state_key
from surgical_tpu_torch.kernels.mit_block import (
    block_weights_from_params,
    fused_mit_block,
    fused_mit_block_packed2,
    fused_mit_stage,
    pack_weights2,
    stage_weights_from_params,
)
from surgical_tpu_torch.models import _ops
from surgical_tpu_torch.utils.trace import span

# surgical_tpu/models/mit_fused.py:81-83
_ROUTE_PACKED2 = False
_PACKED2_ROW_CHUNKS = 2
_PACKED2_MIN_N_FOR_CHUNKING = 2048
# surgical_tpu/models/mit_fused.py:46: stage 4 runs the whole-stage kernel
# only at a batch that is a multiple of 8 (:198); the stage's tanh prompt
# GELU then replaces the per-block path's exact erf. Only stage 4's entry.
_FUSE_BT = {4: 8}


def routes() -> tuple:
    """The route settings above as they stand: part of the key of graphs
    captured over ``fused_forward`` (``serving/feature_graph.py``)."""
    return (_ROUTE_PACKED2, _PACKED2_ROW_CHUNKS, _PACKED2_MIN_N_FOR_CHUNKING,
            tuple(sorted(_FUSE_BT.items())))


def _check_supported(cfg) -> None:
    """Refuse what the fused graphs' kernels and prompt path do not compute:
    another prompt input type or adaptor, a tuning subset, no qkv bias."""
    why = []
    if cfg.input_type != "gaussian":
        why.append(f"input_type={cfg.input_type!r}")
    if cfg.adaptor != "adaptor":
        why.append(f"adaptor={cfg.adaptor!r}")
    if not (cfg.handcrafted_tune and cfg.embedding_tune and cfg.tuning_stage == "1234"):
        why.append(f"handcrafted_tune={cfg.handcrafted_tune}, embedding_tune="
                   f"{cfg.embedding_tune}, tuning_stage={cfg.tuning_stage!r}")
    if not cfg.qkv_bias:
        why.append("qkv_bias=False")
    if why:
        raise NotImplementedError(
            "the fused graphs compute the default prompt configuration only (gaussian input, "
            "adaptor MLPs on all four stages, qkv bias); " + "; ".join(why)
            + ": use the flax graph (MiTEVP.graph_forward, train-backbone without --fused)")


def kernel_weights(model, dtype=torch.bfloat16) -> dict:
    """{stage: [block weight dict per block]} for stages 1-3, {4: stage
    weight dict}, {"block4": [block weight dict per block]} for stage 4's
    per-block route, and {"packed2": {stage: [pack_weights2 dict per
    block]}} for the stages of C = 64 and one head, in the kernels' layout.
    Cached on ``model`` until a parameter or buffer is replaced, moved or
    written in place (``core/state.py``; load_state_dict writes in place)."""
    @torch.no_grad()
    def build():
        blocks = {s: [block_weights_from_params(b, dtype)
                      for b in getattr(model, f"block{s}")] for s in (1, 2, 3, 4)}
        weights = {1: blocks[1], 2: blocks[2], 3: blocks[3], "block4": blocks[4],
                   4: stage_weights_from_params(model, 4, dtype)}
        cfg = model.cfg
        weights["packed2"] = {s: [pack_weights2(w) for w in blocks[s]] for s in blocks
                              if cfg.embed_dims[s - 1] == 64 and cfg.num_heads[s - 1] == 1}
        return weights
    return cached(model, "_kernel_weights", (dtype, state_key(model)), build)


def block_glue(pg, blk, stage: int, d: int, x, base, H: int, W: int, sr: int):
    """The serving and training graphs' plain PyTorch ahead of block ``d`` of
    ``stage``: x plus the prompt MLP (exact-erf GELU) of the stage's prompt
    ``base``, LN1, the SR conv and its LayerNorm, the kv dense -> (x, LN1(x),
    k, v), k and v contiguous."""
    B, C = x.shape[0], x.shape[-1]
    lw = getattr(pg, f"lightweight_mlp{stage}_{d}")[0]
    feat = F.gelu(_ops.dense(base, lw).float()).to(x.dtype)
    x = x + _ops.dense(feat, getattr(pg, f"shared_mlp{stage}"))
    xln = _ops.layernorm(x, blk.norm1)
    kv_in = xln
    if sr > 1:
        red = _ops.conv(xln.reshape(B, H, W, C), blk.attn.sr, sr, 0)
        kv_in = _ops.layernorm(red.reshape(B, -1, C), blk.attn.norm)
    kv = _ops.dense(kv_in, blk.attn.kv)
    return x, xln, kv[..., :C].contiguous(), kv[..., C:].contiguous()


@torch.no_grad()
def fused_forward(model, images, segmaps, flow, return_features: bool = True, weights=None):
    """images, segmaps [B, H, W, 3], flow [B, H, W, 2] or None (any float
    dtype; cast to bf16) -> pooled features [B, E] fp32, or (phase logits,
    anticipation) with ``return_features=False``. ``weights``: the kernel
    weights as ``kernel_weights`` gives them, else taken from its cache
    (which reads parameter addresses, so a graph traced by ``torch.export``
    passes them in)."""
    cfg = model.cfg
    _check_supported(cfg)
    dt = torch.bfloat16
    x = images.to(dt)
    B = x.shape[0]
    pg = model.prompt_generator
    with span("mit.prompts"):
        hand = pg.init_prompts(segmaps.to(dt))
    kw = kernel_weights(model, dt) if weights is None else weights

    grids = []
    for si in range(4):
        stage = si + 1
        with span(f"mit.stage{stage}"):
            x, H, W = getattr(model, f"patch_embed{stage}")(x)
            C = x.shape[-1]
            heads, sr = cfg.num_heads[si], cfg.sr_ratios[si]
            base = hand[stage] + _ops.dense(x, getattr(pg, f"embedding_generator{stage}"))
            if stage == 4 and B % _FUSE_BT[4] == 0:
                # whole stage in one kernel call: in-kernel prompt adds (tanh
                # GELU), LN1 and kv (surgical_tpu/models/mit_fused.py:198)
                x = fused_mit_stage(x.contiguous(), base.contiguous(), kw[stage],
                                    heads=heads, H=H, W=W, sr=sr)
            else:
                blocks_w = kw[stage] if stage < 4 else kw["block4"]
                for d, blk in enumerate(getattr(model, f"block{stage}")):
                    x, _, k, v = block_glue(pg, blk, stage, d, x, base, H, W, sr)
                    if _ROUTE_PACKED2 and C == 64 and heads == 1 and B % 2 == 0:
                        # the JAX module's condition and row-chunk rule (:283-289)
                        N = H * W
                        rc = (_PACKED2_ROW_CHUNKS if N >= _PACKED2_MIN_N_FOR_CHUNKING
                              and H % _PACKED2_ROW_CHUNKS == 0 else 1)
                        x = fused_mit_block_packed2(x.contiguous(), k, v, kw["packed2"][stage][d],
                                                    H=H, W=W, row_chunks=rc)
                    else:
                        x = fused_mit_block(x.contiguous(), k, v, blocks_w[d],
                                            heads=heads, H=H, W=W)
            x = _ops.layernorm(x, getattr(model, f"norm{stage}"))
            grids.append(x.reshape(B, H, W, C))
            x = grids[-1]

    if cfg.with_flow and flow is not None:
        f3, f4 = model.flow_encoder(flow.to(dt))
        for idx, ca, ft in ((2, model.cross_attn_s3, f3), (3, model.cross_attn_s4, f4)):
            g = grids[idx]
            grids[idx] = ca(g.reshape(B, -1, g.shape[-1]), ft).reshape(g.shape)

    return model.head(grids, return_features=return_features)
