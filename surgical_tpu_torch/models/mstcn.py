"""Multi-stage dilated causal TCN (TeCNO-style) over whole-video features.

Port of ``surgical_tpu/models/mstcn.py`` (``MultiStageTCN``) in the
reference's ``MultiStageModel_S`` key names (``stage1_phase``,
``stages.{s}``, ``layers.{i}.conv_dilated``), so the JAX package's
``export_mstcn_state_dict`` loads with ``strict=True``. Inference only.

Causal: each dilated conv (k=3, dilation d) sees ``x[t-2d], x[t-d], x[t]``
through a left padding of ``2d``. The model never looks forward, so a video
runs at its true length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import MSTCNConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


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
    def __init__(self, dilation: int, channels: int, causal: bool = True):
        super().__init__()
        self.dilation, self.causal = dilation, causal
        self.conv_dilated = nn.Conv1d(channels, channels, 3, dilation=dilation)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):  # [B, C, T]
        d = self.dilation
        pad = (2 * d, 0) if self.causal else (d, d)
        h = torch.relu(self.conv_dilated(F.pad(x, pad)))
        return x + self.conv_1x1(h)


class SingleStageTCN(nn.Module):
    """1x1 in-proj, L dilated residual layers (dilations 1..2^(L-1)), 1x1
    out-proj."""

    def __init__(self, layers: int, f_maps: int, dim: int, out_features: int,
                 causal: bool = True):
        super().__init__()
        self.conv_1x1 = nn.Conv1d(dim, f_maps, 1)
        self.layers = nn.ModuleList(
            DilatedResidualLayer(2 ** i, f_maps, causal) for i in range(layers))
        self.conv_out_classes = nn.Conv1d(f_maps, out_features, 1)

    def forward(self, x):  # [B, C, T] -> [B, out, T]
        h = self.conv_1x1(x)
        for layer in self.layers:
            h = layer(h)
        return self.conv_out_classes(h)


class MultiStageTCN(nn.Module):
    """Input [B, T, f_dim] -> [S, B, T, out_features]. Refinement stages take
    the softmax over all out_features channels, as the reference does."""

    def __init__(self, cfg: MSTCNConfig = MSTCNConfig(), *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.stage1_phase = SingleStageTCN(cfg.layers, cfg.f_maps, cfg.f_dim,
                                           cfg.out_features, cfg.causal)
        self.stages = nn.ModuleList(
            SingleStageTCN(cfg.layers, cfg.f_maps, cfg.out_features, cfg.out_features,
                           cfg.causal)
            for _ in range(cfg.stages - 1))
        torch_like_uniform_(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    def forward(self, x):
        out = self.stage1_phase(x.transpose(1, 2))
        outs = [out]
        for stage in self.stages:
            out = stage(torch.softmax(out, dim=1))
            outs.append(out)
        return torch.stack(outs).transpose(-1, -2)
