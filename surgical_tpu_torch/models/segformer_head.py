"""SegFormer pooled head with dual phase/anticipation outputs.

Port of ``surgical_tpu/models/segformer_head.py`` in the reference's key
names (``linear_c{i}.proj``, ``linear_fuse.conv``, ``linear_fuse.bn``,
``fc.{0,2}``, ``fc_ant.{0,2}``): per-stage linear embedding, bilinear
downsampling of stages 1-3 to stage 4's grid, concat in [c4, c3, c2, c1]
order, 1x1 conv + BN + ReLU, channel dropout, global average pool to the LFB
feature, then two MLP heads. In train mode (``bn_stats`` given) the BatchNorm
normalizes with the batch statistics and writes the new running statistics
into ``bn_stats``, and the channel dropout keeps the channels of ``keep``
(one mask per image, broadcast over H and W, as flax's ``broadcast_dims=(1,
2)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import HeadConfig
from surgical_tpu_torch.models import _ops


def bilinear_resize(x, out_hw: tuple[int, int]):
    """align_corners=False bilinear (half-pixel centers) without antialias,
    NHWC, computed in fp32 and rounded to x.dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class _Proj(nn.Module):
    def __init__(self, dim: int, embed: int):
        super().__init__()
        self.proj = nn.Linear(dim, embed)


class _Fuse(nn.Module):
    def __init__(self, embed: int):
        super().__init__()
        self.conv = nn.Conv2d(4 * embed, embed, 1, bias=False)
        self.bn = nn.BatchNorm2d(embed)


class SegFormerPoolHead(nn.Module):
    def __init__(self, cfg: HeadConfig, in_dims: tuple[int, ...]):
        super().__init__()
        E = cfg.embedding_dim
        self.dropout = cfg.dropout
        for i, d in enumerate(in_dims, start=1):
            setattr(self, f"linear_c{i}", _Proj(d, E))
        self.linear_fuse = _Fuse(E)
        self.fc = nn.Sequential(nn.Linear(E, cfg.hidden), nn.ReLU(),
                                nn.Linear(cfg.hidden, cfg.num_phases))
        self.fc_ant = nn.Sequential(nn.Linear(E, cfg.hidden), nn.ReLU(),
                                    nn.Linear(cfg.hidden, cfg.num_phases))

    def forward(self, grids, return_features: bool = True, ops=_ops.FUSED, bn_stats=None,
                keep=None, bn_group=None):
        """grids: 4 NHWC maps c1..c4 in the activation dtype -> the pooled
        feature [B, E], or (phase logits, anticipation) [B, 7] each; fp32
        under ``ops=_ops.FUSED``, the activation dtype under ``_ops.FLAX``.
        ``bn_stats``: a dict for train mode (gets "linear_fuse.bn"; the
        statistics over the process group ``bn_group`` when given); ``keep``:
        [B, E] bool channel-dropout mask, or None."""
        c1, c2, c3, c4 = grids
        target = c4.shape[1:3]
        parts = []
        for i, g in ((4, c4), (3, c3), (2, c2), (1, c1)):
            # resize commutes with the linear projection: downsample first
            if g.shape[1:3] != target:
                g = bilinear_resize(g, target)
            parts.append(ops.dense(g, getattr(self, f"linear_c{i}").proj))
        h = ops.conv(torch.cat(parts, dim=-1), self.linear_fuse.conv, 1, 0)
        if bn_stats is None:
            h = _ops.batchnorm(h, self.linear_fuse.bn)
        else:
            h, bn_stats["linear_fuse.bn"] = _ops.bn_train(h, self.linear_fuse.bn, bn_group)
        h = torch.relu(h)
        if keep is not None:
            h = _ops.dropout(h, keep.to(h.device).reshape(h.shape[0], 1, 1, -1), self.dropout)
        # mean accumulates in fp32 and is rounded to the activation dtype
        feat = h.float().mean(dim=(1, 2)).to(h.dtype)
        if ops.pooled_fp32:
            feat = feat.float()
        if return_features:
            return feat

        def mlp_head(seq):
            return ops.dense(torch.relu(ops.dense(feat, seq[0])), seq[2])

        return mlp_head(self.fc), mlp_head(self.fc_ant)
