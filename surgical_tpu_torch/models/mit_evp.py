"""Prompted SegFormer (MiT-EVP) backbone with optical-flow cross-attention.

Port of ``surgical_tpu/models/mit_evp.py``. ``MiTEVP`` holds its parameters
under the reference's state-dict key names (``patch_embed{s}.proj``,
``block{s}.{d}.attn.q``, ``prompt_generator.lightweight_mlp{s}_{d}.0``,
``flow_encoder.bn{i}``, ``cross_attn_s3.cross_attn.in_proj_weight``,
``head.linear_fuse.conv``, ...), so reference ``.pth`` files and JAX weights
(through ``models.convert.export_evp_state_dict``) load with ``strict=True``.

Its forward is the fused inference graph (``models.mit_fused.fused_forward``):
bf16, BatchNorm from running statistics, the MiT blocks on the Hopper
kernels. This port supports the default prompt configuration (Gaussian
handcrafted prompts, embedding tuning, the ``adaptor`` MLPs on all four
stages, flow fusion); the flax training graph with its other prompt input
types and adaptor modes is a later port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.models import _ops
from surgical_tpu_torch.models.segformer_head import SegFormerPoolHead

_LATER = ("is not ported yet (ROADMAP Queue 1 item 3: the flax-graph MiTEVP with "
          "every prompt input type and adaptor mode)")


def gaussian_blur_5x5(x):
    """Fixed 5x5 binomial blur with reflect padding, depthwise over channels,
    computed in fp32 and rounded to x.dtype. x: [B, H, W, C]."""
    k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device)
    C = x.shape[-1]
    kernel = (torch.outer(k1, k1) / 256.0).expand(C, 1, 5, 5)
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (2, 2, 2, 2), mode="reflect")
    return F.conv2d(xp, kernel, groups=C).permute(0, 2, 3, 1).to(x.dtype)


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patchify + LayerNorm."""

    def __init__(self, patch: int, stride: int, in_ch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        """x NHWC -> (tokens [B, H*W, C], H, W)."""
        y = _ops.conv(x, self.proj, self.proj.stride[0], self.proj.padding[0])
        B, H, W, C = y.shape
        return _ops.layernorm(y.reshape(B, H * W, C), self.norm), H, W


class SRAttention(nn.Module):
    def __init__(self, dim: int, sr_ratio: int, qkv_bias: bool):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)


class MiTBlock(nn.Module):
    """Parameters of one pre-LN SRA + Mix-FFN block; the forward is the
    block kernel (``kernels.mit_block.fused_mit_block``)."""

    def __init__(self, dim: int, mlp_ratio: int, sr_ratio: int, qkv_bias: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, sr_ratio, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))


class PromptGenerator(nn.Module):
    """EVP prompts: handcrafted features from the blurred segmap through a
    cascade of narrow patch embeds, per-stage embedding projections, and the
    per-(stage, depth) lightweight MLPs with a per-stage shared MLP."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        dims, sf = cfg.embed_dims, cfg.prompt_scale_factor
        for s in range(1, 5):
            i = s - 1
            patch, stride, in_ch = (7, 4, cfg.in_chans) if s == 1 else (3, 2, dims[i - 1] // sf)
            setattr(self, f"handcrafted_generator{s}",
                    OverlapPatchEmbed(patch, stride, in_ch, dims[i] // sf))
            setattr(self, f"embedding_generator{s}", nn.Linear(dims[i], dims[i] // sf))
            for d in range(cfg.depths[i]):
                setattr(self, f"lightweight_mlp{s}_{d}", nn.Sequential(
                    nn.Linear(dims[i] // sf, dims[i] // sf), nn.GELU()))
            setattr(self, f"shared_mlp{s}", nn.Linear(dims[i] // sf, dims[i]))

    def init_prompts(self, segmap):
        """Blurred segmap [B, H, W, 3] -> per-stage handcrafted tokens."""
        feats, prev = {}, gaussian_blur_5x5(segmap)
        for s in range(1, 5):
            tokens, H, W = getattr(self, f"handcrafted_generator{s}")(prev)
            feats[s] = tokens
            prev = tokens.reshape(tokens.shape[0], H, W, -1)
        return feats


class OpticalFlowEncoder(nn.Module):
    """4-conv BN-ReLU CNN over flow maps: 2 -> 64 (s4) -> 128 (s2) -> C3 (s2)
    -> C4 (s2); returns the stage-3 and stage-4 token sequences."""

    def __init__(self, dim_s3: int, dim_s4: int):
        super().__init__()
        for i, (cin, cout, k, s) in enumerate(
                ((2, 64, 7, 4), (64, 128, 3, 2), (128, dim_s3, 3, 2), (dim_s3, dim_s4, 3, 2)),
                start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, s, k // 2))
            setattr(self, f"bn{i}", nn.BatchNorm2d(cout))

    def forward(self, flow):
        def enc(h, i):
            c = getattr(self, f"conv{i}")
            h = _ops.conv(h, c, c.stride[0], c.padding[0])
            return torch.relu(_ops.batchnorm(h, getattr(self, f"bn{i}")))

        f3 = enc(enc(enc(flow, 1), 2), 3)
        f4 = enc(f3, 4)
        B = flow.shape[0]
        return f3.reshape(B, -1, f3.shape[-1]), f4.reshape(B, -1, f4.shape[-1])


class MotionGuidedCrossAttention(nn.Module):
    """Q = visual tokens, K/V = flow tokens, residual + LayerNorm. Parameters
    in the layout of torch's ``nn.MultiheadAttention`` (joint in-projection),
    which is what reference checkpoints hold."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.cross_attn = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x_visual, x_flow):
        """einsum + fp32 softmax with the fused graph's bf16 roundings
        (mit_fused.py::_cross_attn)."""
        B, Nv, C = x_visual.shape
        h = self.num_heads
        hd = C // h
        dt = x_visual.dtype
        ca = self.cross_attn
        w, b = ca.in_proj_weight.to(dt).float(), ca.in_proj_bias

        def proj(x, i):
            return (x.float() @ w[i * C:(i + 1) * C].t() + b[i * C:(i + 1) * C]).to(dt)

        q = proj(x_visual, 0).reshape(B, Nv, h, hd)
        k = proj(x_flow, 1).reshape(B, -1, h, hd)
        v = proj(x_flow, 2).reshape(B, -1, h, hd)
        a = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
        a = torch.softmax(a.float(), dim=-1).to(dt)
        o = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(B, Nv, C)
        return _ops.layernorm(x_visual + _ops.dense(o, ca.out_proj), self.norm)


def _check_supported(cfg: BackboneConfig) -> None:
    if cfg.input_type != "gaussian":
        raise NotImplementedError(f"prompt input_type={cfg.input_type!r} {_LATER}")
    if cfg.adaptor != "adaptor":
        raise NotImplementedError(f"adaptor={cfg.adaptor!r} {_LATER}")
    if not (cfg.handcrafted_tune and cfg.embedding_tune and cfg.tuning_stage == "1234"):
        raise NotImplementedError(
            f"handcrafted_tune={cfg.handcrafted_tune}, embedding_tune={cfg.embedding_tune}, "
            f"tuning_stage={cfg.tuning_stage!r} {_LATER}")
    if not (cfg.with_flow and cfg.qkv_bias):
        raise NotImplementedError(
            f"with_flow={cfg.with_flow}, qkv_bias={cfg.qkv_bias} {_LATER}")


def _init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Seeded init in the reference's scheme: Linear trunc-normal(0.02) with
    zero bias; Conv N(0, sqrt(2 / fan_out)) with zero bias; norms at 1/0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.MultiheadAttention):
                nn.init.trunc_normal_(m.in_proj_weight, std=0.02, a=-0.04, b=0.04, generator=g)
                m.in_proj_bias.zero_()


class MiTEVP(nn.Module):
    """The prompted backbone + pooled head.

    forward(images [B, H, W, 3], segmaps [B, H, W, 3], flow [B, H, W, 2] | None,
            return_features=True) -> features [B, E] (fp32), or
            (phase logits, anticipation) with return_features=False.
    """

    def __init__(self, cfg: BackboneConfig = BackboneConfig(),
                 head_cfg: HeadConfig = HeadConfig(), *, seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        _check_supported(cfg)
        self.cfg, self.head_cfg = cfg, head_cfg
        dims = cfg.embed_dims
        ins = (cfg.in_chans,) + tuple(dims[:3])
        for s in range(1, 5):
            i = s - 1
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", OverlapPatchEmbed(patch, stride, ins[i], dims[i]))
            setattr(self, f"block{s}", nn.ModuleList(
                MiTBlock(dims[i], cfg.mlp_ratios[i], cfg.sr_ratios[i], cfg.qkv_bias)
                for _ in range(cfg.depths[i])))
            setattr(self, f"norm{s}", nn.LayerNorm(dims[i], eps=1e-6))
        self.prompt_generator = PromptGenerator(cfg)
        self.flow_encoder = OpticalFlowEncoder(dims[2], dims[3])
        self.cross_attn_s3 = MotionGuidedCrossAttention(dims[2], cfg.flow_heads)
        self.cross_attn_s4 = MotionGuidedCrossAttention(dims[3], cfg.flow_heads)
        self.head = SegFormerPoolHead(head_cfg, dims)
        _init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(device)

    def forward(self, images, segmaps, flow=None, return_features: bool = True):
        from surgical_tpu_torch.models.mit_fused import fused_forward

        return fused_forward(self, images, segmaps, flow, return_features=return_features)
