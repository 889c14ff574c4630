"""Streaming per-frame temporal inference with offline parity.

Port of ``surgical_tpu/serving/online.py`` (``run_pipeline``, ``OnlineMSTCN``,
``OnlineMamba``, ``OnlineRefiner``). The causal temporal models admit a
constant-state streaming form:

- ``OnlineMSTCN``: each dilated residual layer reads x[t], x[t-d], x[t-2d];
  a ring buffer of the last ``2d`` layer inputs per layer replays the
  offline forward's left zero padding (zero-initialised buffers are the
  causal padding).
- ``OnlineMamba``: each block carries its depthwise-conv window (d_conv - 1
  frames) and the fp32 SSM state [d_inner, d_state]; the step is the
  recurrence of ``kernels/selective_scan.py`` in plain tensor math:
      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,
      y_t = h_t @ C_t + D * x_t.
- ``OnlineRefiner``: one ring buffer of the last ``len_q`` temporal logits,
  run through ``RefinementTransformer.refine_window`` per frame.

Each exposes ``init_state``, ``step(state, ...) -> (state, out)`` and
``run(...)``, a Python loop over ``step``. The models are the port's own
modules; their weights are read in place. Dropout is off, as offline.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def run_pipeline(temporal, refiner, feats: torch.Tensor) -> torch.Tensor:
    """Whole-sequence streaming composition: temporal run -> final stage ->
    refiner run. MS-TCN runs give [S, T, out] (the last stage feeds the
    refiner), Mamba runs [T, out]."""
    g = temporal.run(feats)
    if g.dim() == 3:
        g = g[-1]
    return refiner.run(g, feats)


def _push(buf: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Drop the oldest row of ``buf`` and append ``row``."""
    return torch.cat([buf[1:], row[None]])


# --------------------------------------------------------------- MS-TCN


class OnlineMSTCN:
    """Streaming ``MultiStageTCN``: ``feat`` per step is one frame's [f_dim]
    feature; logits are [stages, out_features], the offline [S, B, T, out]
    at the current frame."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.stages = [model.stage1_phase, *model.stages]

    def init_state(self) -> list[list[torch.Tensor]]:
        """Zero ring buffers == the offline causal left padding."""
        p = next(self.model.parameters())
        return [[torch.zeros(2 * 2 ** i, self.cfg.f_maps, dtype=p.dtype, device=p.device)
                 for i in range(self.cfg.layers)] for _ in self.stages]

    @staticmethod
    def _stage_step(stage, bufs, x):
        """One frame through one stage: x [in] -> ([out], bufs')."""
        h = F.linear(x, stage.conv_1x1.weight[:, :, 0], stage.conv_1x1.bias)
        new_bufs = []
        for layer, buf in zip(stage.layers, bufs):
            d = layer.dilation
            k = layer.conv_dilated.weight  # [C, C, 3]: taps t-2d, t-d, t
            hc = (F.linear(buf[0], k[:, :, 0]) + F.linear(buf[d], k[:, :, 1])
                  + F.linear(h, k[:, :, 2]) + layer.conv_dilated.bias)
            hc = F.linear(torch.relu(hc), layer.conv_1x1.weight[:, :, 0], layer.conv_1x1.bias)
            new_bufs.append(_push(buf, h))
            h = h + hc
        out = F.linear(h, stage.conv_out_classes.weight[:, :, 0], stage.conv_out_classes.bias)
        return out, new_bufs

    @torch.no_grad()
    def step(self, state, feat):
        """feat [f_dim] -> (state', logits [stages, out_features])."""
        outs, new_state, x = [], [], feat
        for stage, bufs in zip(self.stages, state):
            out, bufs = self._stage_step(stage, bufs, x)
            outs.append(out)
            new_state.append(bufs)
            x = torch.softmax(out, dim=-1)
        return new_state, torch.stack(outs)

    def run(self, feats):
        """feats [T, f_dim] -> [stages, T, out]."""
        state, outs = self.init_state(), []
        for feat in feats:
            state, logits = self.step(state, feat)
            outs.append(logits)
        return torch.stack(outs, dim=1)


# ---------------------------------------------------------------- Mamba


class OnlineMamba:
    """Streaming ``CausalMambaModel``. State per block: the depthwise-conv
    input window [d_conv - 1, d_inner] and the SSM state [d_inner, d_state]
    in fp32."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg

    def init_state(self):
        cfg, p = self.cfg, next(self.model.parameters())
        return [(torch.zeros(cfg.d_conv - 1, cfg.d_inner, dtype=p.dtype, device=p.device),
                 torch.zeros(cfg.d_inner, cfg.d_state, dtype=torch.float32, device=p.device))
                for _ in range(cfg.layers)]

    @staticmethod
    def _block_step(block, state, u):
        conv_buf, h = state
        x, z = block.in_proj(u).chunk(2, dim=-1)
        window = torch.cat([conv_buf, x[None]])                 # [d_conv, d_in]
        k = block.conv1d.weight[:, 0, :].t()                    # [d_conv, d_in]
        xc = F.silu((window * k).sum(0) + block.conv1d.bias)
        dt, B, C = block.ssm_inputs(xc)
        A = -torch.exp(block.A_log.float())                     # [d_in, N]
        xc32, dt32 = xc.float(), dt.float()
        a = torch.exp(dt32[:, None] * A)
        b = (dt32 * xc32)[:, None] * B.float()[None, :]
        h = a * h + b
        y = h @ C.float() + block.D.float() * xc32               # [d_in]
        y = y.to(u.dtype) * F.silu(z)
        return (window[1:], h), block.out_proj(y)

    @torch.no_grad()
    def step(self, state, feat):
        """feat [f_dim] -> (state', logits [out_features])."""
        m = self.model
        h = m.in_proj(feat)
        new_state = []
        for block, st in zip(m.blocks, state):
            st, y = self._block_step(block, st, h)
            new_state.append(st)
            h = h + y
        return new_state, m.head(m.norm(h))

    def run(self, feats):
        """feats [T, f_dim] -> [T, out]."""
        state, outs = self.init_state(), []
        for feat in feats:
            state, logits = self.step(state, feat)
            outs.append(logits)
        return torch.stack(outs)


# -------------------------------------------------------------- refiner


class OnlineRefiner:
    """Streaming ``RefinementTransformer``: frame t reads the zero-left-padded
    window of the last ``len_q`` temporal logits plus its own LFB feature, so
    the state is one ring buffer of logits and the output is exact with no
    added latency."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg

    def init_state(self) -> torch.Tensor:
        p = next(self.model.parameters())
        return torch.zeros(self.cfg.len_q, self.cfg.out_features, dtype=p.dtype,
                           device=p.device)

    @torch.no_grad()
    def step(self, state, g_t, lfb_t):
        """(buffer, final-stage temporal logits [out], LFB feature [f_dim])
        -> (buffer', refined logits [out])."""
        buf = _push(state, g_t)
        return buf, self.model.refine_window(buf, lfb_t)

    def run(self, temporal_logits, lfb):
        """[T, out], [T, f_dim] -> [T, out]."""
        state, outs = self.init_state(), []
        for g_t, lfb_t in zip(temporal_logits, lfb):
            state, out = self.step(state, g_t, lfb_t)
            outs.append(out)
        return torch.stack(outs)
