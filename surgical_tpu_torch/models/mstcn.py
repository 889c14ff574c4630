"""Multi-stage dilated causal TCN (TeCNO-style) over whole-video features.

Port of ``surgical_tpu/models/mstcn.py`` (``MultiStageTCN``) in the
reference's ``MultiStageModel_S`` key names (``stage1_phase``,
``stages.{s}``, ``layers.{i}.conv_dilated``), so the JAX package's
``export_mstcn_state_dict`` loads with ``strict=True``.

Causal: each dilated conv (k=3, dilation d) sees ``x[t-2d], x[t-d], x[t]``
through a left padding of ``2d``. The model never looks forward, so a video
runs at its true length.

Dropout follows ``conv_1x1`` in every residual layer, as in the JAX model,
with flax's semantics (``dropout``): it acts only in train mode, keeps each
value with probability 1 - p and scales the kept ones by 1 / (1 - p). Its
masks come from a ``DropoutMasks`` passed to ``forward``, which draws them
from a ``torch.Generator`` or hands out injected ones, in the JAX layout
[B, T, C] and in call order; ``nn.Dropout`` takes no generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import MSTCNConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


class DropoutMasks:
    """Keep-masks for the temporal models' dropout, in call order: drawn from
    ``generator`` (keep where a uniform draw is below 1 - p, as
    ``jax.random.bernoulli``), or taken one by one from ``masks`` (bool
    tensors in the JAX layout, e.g. flax's own, in tests)."""

    def __init__(self, generator: torch.Generator | None = None, masks=None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        if self.masks is not None:
            mask = self.masks.pop(0)
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"injected dropout mask {tuple(mask.shape)} != {tuple(shape)}")
            return mask.to(device=device, dtype=torch.bool)
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate


def dropout(x, rate: float, training: bool, masks: DropoutMasks | None):
    """flax ``nn.Dropout`` on x in the JAX layout: the identity outside train
    mode or at rate 0; else x / (1 - rate) where kept and 0 elsewhere."""
    if not training or rate == 0.0:
        return x
    if masks is None:
        raise ValueError("dropout in train mode needs a DropoutMasks (forward's `masks`)")
    keep = masks.keep(x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def torch_like_uniform_(module: nn.Module, g: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every conv/linear weight and
    bias, drawn from ``g`` (the JAX package's ``torch_like_uniform``)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                fan_in = m.weight[0].numel()
                bound = fan_in ** -0.5
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)


class DilatedResidualLayer(nn.Module):
    def __init__(self, dilation: int, channels: int, causal: bool = True,
                 dropout: float = 0.5):
        super().__init__()
        self.dilation, self.causal, self.rate = dilation, causal, dropout
        self.conv_dilated = nn.Conv1d(channels, channels, 3, dilation=dilation)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)

    def forward(self, x, masks: DropoutMasks | None = None):  # [B, C, T]
        d = self.dilation
        pad = (2 * d, 0) if self.causal else (d, d)
        h = self.conv_1x1(torch.relu(self.conv_dilated(F.pad(x, pad))))
        h = dropout(h.transpose(1, 2), self.rate, self.training, masks).transpose(1, 2)
        return x + h


class SingleStageTCN(nn.Module):
    """1x1 in-proj, L dilated residual layers (dilations 1..2^(L-1)), 1x1
    out-proj."""

    def __init__(self, layers: int, f_maps: int, dim: int, out_features: int,
                 causal: bool = True, dropout: float = 0.5):
        super().__init__()
        self.conv_1x1 = nn.Conv1d(dim, f_maps, 1)
        self.layers = nn.ModuleList(
            DilatedResidualLayer(2 ** i, f_maps, causal, dropout) for i in range(layers))
        self.conv_out_classes = nn.Conv1d(f_maps, out_features, 1)

    def forward(self, x, masks: DropoutMasks | None = None):  # [B, C, T] -> [B, out, T]
        h = self.conv_1x1(x)
        for layer in self.layers:
            h = layer(h, masks)
        return self.conv_out_classes(h)


class MultiStageTCN(nn.Module):
    """Input [B, T, f_dim] -> [S, B, T, out_features]. Refinement stages take
    the softmax over all out_features channels, as the reference does.
    ``masks`` supplies the dropout masks in train mode."""

    def __init__(self, cfg: MSTCNConfig = MSTCNConfig(), *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.stage1_phase = SingleStageTCN(cfg.layers, cfg.f_maps, cfg.f_dim,
                                           cfg.out_features, cfg.causal, cfg.dropout)
        self.stages = nn.ModuleList(
            SingleStageTCN(cfg.layers, cfg.f_maps, cfg.out_features, cfg.out_features,
                           cfg.causal, cfg.dropout)
            for _ in range(cfg.stages - 1))
        torch_like_uniform_(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    def forward(self, x, masks: DropoutMasks | None = None):
        out = self.stage1_phase(x.transpose(1, 2), masks)
        outs = [out]
        for stage in self.stages:
            out = stage(torch.softmax(out, dim=1), masks)
            outs.append(out)
        return torch.stack(outs).transpose(-1, -2)
