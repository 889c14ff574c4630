"""Streaming per-frame temporal inference with offline parity.

Port of ``surgical_tpu/serving/online.py`` (``run_pipeline``, ``OnlineMSTCN``,
``OnlineMamba``, ``OnlineRefiner``, ``OnlineSession``). The causal temporal
models admit a constant-state streaming form:

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
``OnlineSession`` puts the frozen backbone's feature extraction in front:
frames in, phase logits out.

On the card the session's feature leg runs as CUDA graphs of the glue
between the MiT kernel calls (``serving/feature_graph.py``): the first
frame of a key is run eagerly and captured, and every later frame replays
the graphs and calls the kernels eagerly between them, through the entry
points ``models/mit_fused.py`` holds, so that their launch counters, their
error checks and any wrapper of the entries see every call. The key is the
frame's shapes and dtypes, whether flow is present, and the address and
in-place version of every backbone parameter and buffer: replacing or
loading weights (``load_state_dict``) makes the next frame capture again;
``reset`` touches only the temporal states and keeps the graphs. The
session's device memory then holds one graph pool (one frame's glue
activations). The temporal and refiner steps stay eager. On the CPU the
feature leg is eager. Extraction (``train/extract.py``) never graphs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from surgical_tpu_torch.serving.feature_graph import FeatureGraph
from surgical_tpu_torch.train.extract import WireForward, use_fused_default
from surgical_tpu_torch.utils.trace import span


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


# -------------------------------------------------------------- session


class OnlineSession:
    """Frame-in / phase-out streaming pipeline: the frozen backbone's
    features (the extraction contract, one B = 1 micro-batch per frame)
    chained into a streaming temporal model and, when given, the refiner.

    ``temporal`` is an ``OnlineMSTCN`` or ``OnlineMamba``; frames follow
    ``train/extract.py``'s wire format (uint8 image and segmap, float16
    flow). ``use_fused`` picks the backbone's graph as ``make_raw_feature_fn``
    does (None: the kernels for a preset-size backbone on the card). The
    features leave the backbone in ``feature_dtype`` (the extraction wire,
    float16, on which the temporal models are trained) and enter the
    temporal step in fp32. The temporal and refiner models must sit on the
    backbone's device: the session moves nothing.

    On the card the feature leg replays CUDA graphs of the glue between the
    MiT kernel calls, which stay eager through their entry points (the
    module docstring; ``serving/feature_graph.py``). A frame of new shapes,
    a frame with flow after one without (or the reverse), and any replaced
    or in-place written backbone parameter or buffer cause one new capture
    (that frame runs eagerly); ``reset`` does not. The session holds one
    graph pool in device memory.
    """

    def __init__(self, backbone, temporal, refiner: Optional[OnlineRefiner] = None,
                 use_fused: Optional[bool] = None, feature_dtype=torch.float16):
        device = next(backbone.parameters()).device
        for name, part in (("temporal", temporal), ("refiner", refiner)):
            if part is not None and next(part.model.parameters()).device != device:
                raise ValueError(
                    f"the {name} model's parameters are on "
                    f"{next(part.model.parameters()).device}, the backbone's on {device}: "
                    "move it to the backbone's device (the session moves nothing)")
        # a flow-trained backbone gates its flow fusion on `flow is not None`:
        # serving it without flow would give other features, so step refuses
        self._needs_flow = backbone.cfg.with_flow
        if use_fused is None:
            use_fused = use_fused_default(backbone.cfg, device)
        self._features = FeatureGraph(WireForward(backbone, use_fused, out_dtype=feature_dtype),
                                      backbone)
        self.temporal, self.refiner = temporal, refiner
        self.reset()

    def reset(self) -> None:
        self.state = self.temporal.init_state()
        self.refiner_state = self.refiner.init_state() if self.refiner else None
        self.frame_idx = 0

    def features(self, img_u8, seg_u8, flow_f16) -> torch.Tensor:
        """One frame ([H, W, 3] u8, [H, W, 1] u8, [H, W, 2] f16 or None) ->
        its feature [E] in fp32 on the backbone's device (the feature leg)."""
        if self._needs_flow and flow_f16 is None:
            raise ValueError(
                "backbone was built with with_flow=True: serving without a "
                "flow frame silently skips the flow cross-attention and "
                "produces wrong features; pass flow_f16 (precompute with "
                "models/raft.py) or rebuild the backbone with with_flow=False")
        # a batch axis with the strides of a stacked batch: a[None] gives it
        # stride 0, for which the convolutions may take another memory-format
        # path and round differently from offline extraction
        one = lambda a: None if a is None else a.reshape((1, *a.shape))
        with span("session.features"):
            return self._features(one(img_u8), one(seg_u8), one(flow_f16))[0].float()

    def advance(self, feat: torch.Tensor) -> torch.Tensor:
        """One frame's feature [E] -> its logits (the temporal + refiner
        leg): the temporal step, then, with a refiner, the refiner step on
        the temporal model's final stage and the same feature."""
        self.frame_idx += 1
        with span("session.temporal"):
            self.state, logits = self.temporal.step(self.state, feat)
        g = logits[-1] if logits.dim() == 2 else logits
        if self.refiner is None:
            return g
        with span("session.refiner"):
            self.refiner_state, refined = self.refiner.step(self.refiner_state, g, feat)
        return refined

    def step(self, img_u8, seg_u8, flow_f16) -> np.ndarray:
        """One frame -> this frame's logits: refined when a refiner is
        attached (the full pipeline, online), else the temporal model's
        final stage."""
        return self.advance(self.features(img_u8, seg_u8, flow_f16)).cpu().numpy()
