"""Causal Mamba temporal model: the drop-in for the MS-TCN.

Port of ``surgical_tpu/models/mamba.py`` (``MambaBlock``,
``CausalMambaModel``) in the key names of the reference's
``CausalMambaModel`` (``in_proj``, ``blocks.{i}.{in_proj, conv1d, x_proj,
dt_proj, A_log, D, out_proj}``, ``norm``, ``head``), so that
``export_mamba_state_dict`` loads with ``strict=True``. Dropout follows
each residual block, as in the JAX model (``models/mstcn.py::dropout``: train
mode only, masks from the ``DropoutMasks`` given to ``forward``).

The block: in_proj -> [x, z]; depthwise causal conv over time (d_conv - 1
frames of left zero padding) + SiLU on x; x_proj -> dt, B, C;
dt = softplus(dt_proj(dt)); the selective scan in fp32 with A = -exp(A_log)
(``kernels/selective_scan.py``, the Hopper kernels on CUDA, forward and,
under grad, backward), cast back to the input dtype; gate by SiLU(z);
out_proj. The final LayerNorm uses eps 1e-6 (flax's default), not torch's
1e-5. Every step is causal, so a video runs at its true length.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import MambaConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.kernels import selective_scan as scan_kernel
from surgical_tpu_torch.models.mstcn import DropoutMasks, dropout, torch_like_uniform_

LN_EPS = 1e-6


def causal_depthwise_conv(x, weight, bias, left=None):
    """x [B, T, C], weight [C, 1, K], bias [C] -> [B, T, C]:
    out[t] = sum_k x[t - K + 1 + k] * weight[:, 0, k] + bias, zeros before
    t = 0, or the K - 1 frames ``left`` [B, K - 1, C] there (a time shard's
    halo, ``parallel/sequence.py``). Written out tap by tap in fp32 (no
    cuDNN, so no TF32), the same arithmetic as ``OnlineMamba``'s per-frame
    window."""
    K, T = weight.shape[-1], x.shape[1]
    padded = F.pad(x, (0, 0, K - 1, 0)) if left is None else torch.cat([left, x], dim=1)
    w = weight[:, 0, :]
    out = padded[:, 0:T] * w[:, 0]
    for k in range(1, K):
        out = out + padded[:, k:k + T] * w[:, k]
    return out + bias


class MambaBlock(nn.Module):
    """u [B, T, d_model] -> [B, T, d_model] (the residual add is the
    caller's)."""

    # serving/online.py::OnlineMamba steps this block's math one frame at a
    # time; tests/test_torch_serving.py holds the two together.

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        self.cfg = cfg
        d_in, n = cfg.d_inner, cfg.d_state
        self.in_proj = nn.Linear(cfg.d_model, 2 * d_in, bias=False)
        self.conv1d = nn.Conv1d(d_in, d_in, cfg.d_conv, groups=d_in)
        self.x_proj = nn.Linear(d_in, cfg.resolved_dt_rank + 2 * n, bias=False)
        self.dt_proj = nn.Linear(cfg.resolved_dt_rank, d_in)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, n + 1, dtype=torch.float32)
                                            ).repeat(d_in, 1))
        self.D = nn.Parameter(torch.ones(d_in))
        self.out_proj = nn.Linear(d_in, cfg.d_model, bias=False)

    def ssm_inputs(self, x):
        """Post-conv activations x [..., d_in] -> (dt [..., d_in], B, C
        [..., d_state]), dt through softplus."""
        cfg = self.cfg
        dt, B, C = self.x_proj(x).split(
            [cfg.resolved_dt_rank, cfg.d_state, cfg.d_state], dim=-1)
        return F.softplus(self.dt_proj(dt)), B, C

    def forward(self, u):
        x, z = self.in_proj(u).chunk(2, dim=-1)
        x = F.silu(causal_depthwise_conv(x, self.conv1d.weight, self.conv1d.bias))
        dt, B, C = self.ssm_inputs(x)
        A = -torch.exp(self.A_log.float())
        f32 = lambda t: t.float().contiguous()
        y = scan_kernel.selective_scan(f32(x), f32(dt), A.contiguous(), f32(B), f32(C),
                                       f32(self.D)).to(u.dtype)
        return self.out_proj(y * F.silu(z))


def _dt_bias_(bias: torch.Tensor, g: torch.Generator, dt_min=1e-3, dt_max=0.1) -> None:
    """mamba_ssm's dt bias init: softplus^-1 of log-uniform dt samples."""
    u = torch.rand(bias.shape, generator=g)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=1e-4)
    bias.copy_(dt + torch.log(-torch.expm1(-dt)))


class CausalMambaModel(nn.Module):
    """[B, T, f_dim] -> [1, B, T, out_features] (singleton stage axis, as the
    reference's mstcn.py:328-343, so callers keep ``outputs[-1]``).
    ``masks`` supplies the dropout masks in train mode."""

    def __init__(self, cfg: MambaConfig = MambaConfig(), *, seed: int = 0,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.in_proj = nn.Linear(cfg.f_dim, cfg.d_model)
        self.blocks = nn.ModuleList(MambaBlock(cfg) for _ in range(cfg.layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.head = nn.Linear(cfg.d_model, cfg.out_features)
        g = torch.Generator().manual_seed(seed)
        torch_like_uniform_(self, g)
        with torch.no_grad():
            for block in self.blocks:
                _dt_bias_(block.dt_proj.bias, g)
        self.eval()
        self.to(device)

    def forward(self, x, masks: DropoutMasks | None = None):
        h = self.in_proj(x)
        for block in self.blocks:
            h = dropout(h + block(h), self.cfg.dropout, self.training, masks)
        return self.head(self.norm(h))[None]
