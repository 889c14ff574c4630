"""Prompted SegFormer (MiT-EVP) backbone with optical-flow cross-attention.

Port of ``surgical_tpu/models/mit_evp.py``. ``MiTEVP`` holds its parameters
under the reference's state-dict key names (``patch_embed{s}.proj``,
``block{s}.{d}.attn.q``, ``prompt_generator.lightweight_mlp{s}_{d}.0``,
``prompt_generator.fully_shared_mlp{s}.2``, ``prompt_generator.bimask_pos_embed``,
``flow_encoder.bn{i}``, ``cross_attn_s3.cross_attn.in_proj_weight``,
``head.linear_fuse.conv``, ...), so reference ``.pth`` files and JAX weights
(through ``models.convert.export_evp_state_dict``) load with ``strict=True``.
It builds every ``BackboneConfig``: each prompt input type (``gaussian``,
``srm``, ``fft``, ``all``, ``bimask``, raw), each adaptor mode (``adaptor``,
``fully_shared``, ``fully_unshared``), handcrafted or embedding tuning off,
a ``tuning_stage`` subset, no flow, no qkv bias; a module exists only where
the flax model would create its parameters.

Two graphs run it:
- ``forward`` is the fused serving graph (``models.mit_fused.fused_forward``):
  bf16, BatchNorm from running statistics, the MiT blocks on the Hopper
  kernels; it takes the default prompt configuration only, and
  ``models.mit_train.fused_train_forward`` is its training counterpart;
- ``graph_forward`` is the flax module graph (``MiTEVP.__call__``) in plain
  PyTorch at a compute dtype, with flax's roundings (``_ops.FLAX``): eval or
  train mode (per-sample DropPath, dropout, BatchNorm from batch
  statistics), the attention probabilities of every block on request. Its
  attention is an einsum with an fp32 softmax, as in JAX; it launches no
  kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from surgical_tpu_torch.models import _ops
from surgical_tpu_torch.models.mit_train import draw_masks, droppath_rates
from surgical_tpu_torch.models.segformer_head import SegFormerPoolHead


def gaussian_blur_5x5(x):
    """Fixed 5x5 binomial blur with reflect padding, depthwise over channels,
    computed in fp32 and rounded to x.dtype. x: [B, H, W, C]."""
    k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device)
    C = x.shape[-1]
    kernel = (torch.outer(k1, k1) / 256.0).expand(C, 1, 5, 5)
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (2, 2, 2, 2), mode="reflect")
    return F.conv2d(xp, kernel, groups=C).permute(0, 2, 3, 1).to(x.dtype)


# surgical_tpu/models/mit_evp.py:252-271
SRM_FILTERS = np.asarray(
    [
        [[0, 0, 0, 0, 0],
         [0, -1 / 4, 2 / 4, -1 / 4, 0],
         [0, 2 / 4, -4 / 4, 2 / 4, 0],
         [0, -1 / 4, 2 / 4, -1 / 4, 0],
         [0, 0, 0, 0, 0]],
        [[-1 / 12, 2 / 12, -2 / 12, 2 / 12, -1 / 12],
         [2 / 12, -6 / 12, 8 / 12, -6 / 12, 2 / 12],
         [-2 / 12, 8 / 12, -12 / 12, 8 / 12, -2 / 12],
         [2 / 12, -6 / 12, 8 / 12, -6 / 12, 2 / 12],
         [-1 / 12, 2 / 12, -2 / 12, 2 / 12, -1 / 12]],
        [[0, 0, 0, 0, 0],
         [0, 0, 0, 0, 0],
         [0, 1 / 2, -2 / 2, 1 / 2, 0],
         [0, 0, 0, 0, 0],
         [0, 0, 0, 0, 0]],
    ],
    dtype=np.float32,
)


def srm_filter(x):
    """Fixed SRM noise-residual filters, zero 'SAME' padding, in fp32 and
    rounded to x.dtype: output channel k is SRM kernel k summed over the 3
    input channels. x: [B, H, W, 3]."""
    w = torch.from_numpy(SRM_FILTERS).to(x.device)[:, None].expand(3, 3, 5, 5)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, padding=2)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def fft_prompt(x, rate: float = 0.25, prompt_type: str = "highpass"):
    """Frequency-domain prompt: zero a centered low-frequency square of
    relative area ``rate`` (highpass) or keep only it (lowpass), in fp32 /
    complex64, the real part rounded to x.dtype. x: [B, H, W, C]."""
    B, H, W, C = x.shape
    fx = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(1, 2)), dim=(1, 2))
    hh, ww = int(H * math.sqrt(rate) / 2), int(W * math.sqrt(rate) / 2)
    yy = (torch.arange(H, device=x.device) - H // 2).abs()[:, None]
    xx = (torch.arange(W, device=x.device) - W // 2).abs()[None, :]
    low = ((yy <= hh) & (xx <= ww))[None, :, :, None]
    fx = torch.where(~low if prompt_type == "highpass" else low, fx, torch.zeros_like(fx))
    out = torch.fft.ifft2(torch.fft.ifftshift(fx, dim=(1, 2)), dim=(1, 2))
    return out.real.to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch: ``factor`` [B] is
    0 (dropped) or 1 / keep (kept), as ``draw_masks`` draws it; x / keep
    where kept, else 0, in x.dtype. Identity at rate 0 or without a
    factor."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, factor=None):
        if self.rate == 0.0 or factor is None:
            return x
        kept = (factor > 0).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(kept, x / (1.0 - self.rate), torch.zeros_like(x))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patchify + LayerNorm."""

    def __init__(self, patch: int, stride: int, in_ch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch, stride, patch // 2)
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, ops=_ops.FUSED):
        """x NHWC -> (tokens [B, H*W, C], H, W)."""
        y = ops.conv(x, self.proj, self.proj.stride[0], self.proj.padding[0])
        B, H, W, C = y.shape
        return ops.layernorm(y.reshape(B, H * W, C), self.norm), H, W


class SRAttention(nn.Module):
    """Spatial-reduction attention: queries from every token, keys and
    values from an sr x sr strided conv + LayerNorm of the grid when sr > 1.
    The forward is the flax module's (surgical_tpu/models/mit_evp.py:119-178)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, qkv_bias: bool):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, H: int, W: int, proj_keep=None, drop_rate: float = 0.0):
        """x [B, N, C] -> (out [B, N, C], attention probabilities [B, h, N,
        Nkv] in x.dtype). ``proj_keep``: the output dropout's keep mask."""
        B, N, C = x.shape
        h = self.num_heads
        hd = C // h
        q = _ops.flax_dense(x, self.q).reshape(B, N, h, hd)
        kv_in = x
        if self.sr_ratio > 1:
            grid = _ops.flax_conv(x.reshape(B, H, W, C), self.sr, self.sr_ratio, "SAME")
            kv_in = _ops.flax_layernorm(grid.reshape(B, -1, C), self.norm)
        kv = _ops.flax_dense(kv_in, self.kv).reshape(B, -1, 2, h, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd ** -0.5
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        out = _ops.flax_dense(out, self.proj)
        if proj_keep is not None:
            out = _ops.dropout(out, proj_keep, drop_rate)
        return out, attn


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, H: int, W: int):
        """3x3 depthwise conv on the token grid, [B, N, C] -> [B, N, C]."""
        B, N, C = x.shape
        return _ops.flax_conv(x.reshape(B, H, W, C), self.dwconv, 1, 1).reshape(B, N, C)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, H: int, W: int, keeps=None, drop_rate: float = 0.0):
        """fc1 -> DWConv -> exact-erf GELU -> dropout -> fc2 -> dropout;
        ``keeps``: (hidden keep mask, output keep mask) or None."""
        x = F.gelu(self.dwconv(_ops.flax_dense(x, self.fc1), H, W))
        if keeps is not None:
            x = _ops.dropout(x, keeps[0], drop_rate)
        x = _ops.flax_dense(x, self.fc2)
        if keeps is not None:
            x = _ops.dropout(x, keeps[1], drop_rate)
        return x


class MiTBlock(nn.Module):
    """One pre-LN SRA + Mix-FFN block with stochastic depth. The fused
    graphs run its parameters through the block kernels
    (``kernels.mit_block``); the forward is the flax module's."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int,
                 qkv_bias: bool, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, H: int, W: int, droppath=(None, None), drops=None,
                drop_rate: float = 0.0):
        """x [B, N, C] -> (x [B, N, C], attention probabilities).
        ``droppath``: the two branches' DropPath factors; ``drops``: the
        (attention output, MLP hidden, MLP output) dropout keep masks."""
        drops = drops or (None, None, None)
        a, attn = self.attn(_ops.flax_layernorm(x, self.norm1), H, W, drops[0], drop_rate)
        x = x + self.drop_path(a, droppath[0])
        m = self.mlp(_ops.flax_layernorm(x, self.norm2), H, W,
                     None if drops[1] is None else drops[1:], drop_rate)
        return x + self.drop_path(m, droppath[1]), attn


class PromptGenerator(nn.Module):
    """EVP prompts: handcrafted features from the prompt input (the blurred,
    SRM-filtered or frequency-filtered segmap, a fixed zero prompt, the
    segmap plus a learned positional embedding, or the raw segmap) through a
    cascade of narrow patch embeds, per-stage embedding projections, and the
    adaptor MLPs whose output is added to the tokens before every block.
    Only the stages of ``tuning_stage`` have modules; the adaptors exist when
    either tuning is on (the flax model creates them on first use)."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        dims, sf = cfg.embed_dims, cfg.prompt_scale_factor
        if cfg.input_type == "all":
            # fixed zero prompt, outside the state dict (JAX's "constants")
            self.register_buffer("all_prompt", torch.zeros(cfg.img_size, cfg.img_size, 3),
                                 persistent=False)
        if cfg.input_type == "bimask":
            # the reference's [3, H, W] layout
            self.bimask_pos_embed = nn.Parameter(torch.zeros(3, cfg.img_size, cfg.img_size))
        in_ch = cfg.in_chans  # the cascade skips untuned stages, as flax's
        for s in sorted(int(c) for c in cfg.tuning_stage):
            i, c = s - 1, dims[s - 1] // sf
            if cfg.handcrafted_tune:
                patch, stride = (7, 4) if s == 1 else (3, 2)
                setattr(self, f"handcrafted_generator{s}", OverlapPatchEmbed(patch, stride, in_ch, c))
                in_ch = c
            if cfg.embedding_tune:
                setattr(self, f"embedding_generator{s}", nn.Linear(dims[i], c))
            if not (cfg.handcrafted_tune or cfg.embedding_tune):
                continue
            if cfg.adaptor == "adaptor":
                for d in range(cfg.depths[i]):
                    setattr(self, f"lightweight_mlp{s}_{d}", nn.Sequential(nn.Linear(c, c), nn.GELU()))
                setattr(self, f"shared_mlp{s}", nn.Linear(c, dims[i]))
            elif cfg.adaptor == "fully_shared":
                setattr(self, f"fully_shared_mlp{s}", _two_layer(c, dims[i]))
            elif cfg.adaptor == "fully_unshared":
                for d in range(cfg.depths[i]):
                    setattr(self, f"fully_unshared_mlp{s}_{d}", _two_layer(c, dims[i]))
            else:
                raise ValueError(f"unknown adaptor {cfg.adaptor!r}")

    def prompt_input(self, segmap):
        """The handcrafted cascade's input for ``cfg.input_type``."""
        kind = self.cfg.input_type
        if kind == "gaussian":
            return gaussian_blur_5x5(segmap)
        if kind == "srm":
            return srm_filter(segmap)
        if kind == "fft":
            return fft_prompt(segmap, self.cfg.freq_nums, self.cfg.prompt_type)
        if kind == "all":
            return self.all_prompt[None].to(segmap.dtype).expand(segmap.shape)
        if kind == "bimask":
            return segmap + self.bimask_pos_embed.permute(1, 2, 0)[None].to(segmap.dtype)
        return segmap

    def init_prompts(self, segmap, ops=_ops.FUSED):
        """Segmap [B, H, W, 3] -> {stage: handcrafted tokens or None}."""
        feats, prev = {s: None for s in range(1, 5)}, None
        for s in range(1, 5):
            gen = getattr(self, f"handcrafted_generator{s}", None)
            if gen is None:
                continue
            if prev is None:
                prev = self.prompt_input(segmap)
            tokens, H, W = gen(prev, ops)
            feats[s] = tokens
            prev = tokens.reshape(tokens.shape[0], H, W, -1)
        return feats

    def get_prompt(self, x, hand, emb, stage: int, depth: int):
        """x + the adaptor's prompt for (stage, depth) from the handcrafted
        tokens and the embedding projection (either may be None), at x.dtype
        with flax's roundings and exact-erf GELU."""
        feat = hand if emb is None else emb if hand is None else hand + emb
        if feat is None:
            return x
        if self.cfg.adaptor == "adaptor":
            lw = getattr(self, f"lightweight_mlp{stage}_{depth}")[0]
            feat = _ops.flax_dense(F.gelu(_ops.flax_dense(feat, lw)),
                                   getattr(self, f"shared_mlp{stage}"))
        else:
            name = (f"fully_shared_mlp{stage}" if self.cfg.adaptor == "fully_shared"
                    else f"fully_unshared_mlp{stage}_{depth}")
            mlp = getattr(self, name)
            feat = _ops.flax_dense(F.gelu(_ops.flax_dense(feat, mlp[0])), mlp[2])
        return x + feat


def _two_layer(c: int, dim: int) -> nn.Sequential:
    """The reference's fully_(un)shared adaptor: Linear, GELU, Linear (keys
    .0 and .2)."""
    return nn.Sequential(nn.Linear(c, c), nn.GELU(), nn.Linear(c, dim))


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

    def forward(self, flow, ops=_ops.FUSED, bn_stats=None):
        """flow [B, H, W, 2] -> (stage-3 tokens, stage-4 tokens). In train
        mode (``bn_stats`` a dict) BatchNorm uses the batch statistics and
        the new running statistics go into ``bn_stats`` as "bn{i}"."""
        def enc(h, i):
            c, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            h = ops.conv(h, c, c.stride[0], c.padding[0])
            if bn_stats is None:
                h = _ops.batchnorm(h, bn)
            else:
                h, bn_stats[f"bn{i}"] = _ops.bn_train(h, bn)
            return torch.relu(h)

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

    def forward(self, x_visual, x_flow, ops=_ops.FUSED):
        """einsum + fp32 softmax rounded to the activation dtype, the
        projections with ``ops``' roundings (mit_fused.py::_cross_attn for
        ``_ops.FUSED``, the flax module for ``_ops.FLAX``)."""
        B, Nv, C = x_visual.shape
        h = self.num_heads
        hd = C // h
        dt = x_visual.dtype
        ca = self.cross_attn
        w, b = ca.in_proj_weight, ca.in_proj_bias

        def proj(x, i):
            return ops.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])

        q = proj(x_visual, 0).reshape(B, Nv, h, hd)
        k = proj(x_flow, 1).reshape(B, -1, h, hd)
        v = proj(x_flow, 2).reshape(B, -1, h, hd)
        a = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd)
        a = torch.softmax(a.float(), dim=-1).to(dt)
        o = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(B, Nv, C)
        return ops.layernorm(x_visual + ops.dense(o, ca.out_proj), self.norm)


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


def _lecun_normal_(w, g: torch.Generator) -> None:
    """flax's default kernel init (``lecun_normal``): a normal truncated at
    two standard deviations, of variance 1 / fan_in after the truncation."""
    std = 1.0 / math.sqrt(w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


def _init_flax_defaults(modules, g: torch.Generator) -> None:
    """The JAX model leaves the head's and the cross-attentions' kernels at
    flax's default init (lecun-normal; zero biases), where the trunk and the
    prompt generator take the reference's scheme: redraw them so."""
    with torch.no_grad():
        for module in modules:
            for m in module.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    _lecun_normal_(m.weight, g)
                elif isinstance(m, nn.MultiheadAttention):
                    C = m.embed_dim
                    for i in range(3):
                        _lecun_normal_(m.in_proj_weight[i * C:(i + 1) * C], g)


class MiTEVP(nn.Module):
    """The prompted backbone + pooled head.

    forward(images [B, H, W, 3], segmaps [B, H, W, 3], flow [B, H, W, 2] | None,
            return_features=True) -> features [B, E] (fp32), or
            (phase logits, anticipation) with return_features=False: the
            fused serving graph.
    graph_forward(...): the flax module graph (see its docstring).
    """

    def __init__(self, cfg: BackboneConfig = BackboneConfig(),
                 head_cfg: HeadConfig = HeadConfig(), *, seed: int = 0, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.head_cfg = cfg, head_cfg
        dims = cfg.embed_dims
        ins = (cfg.in_chans,) + tuple(dims[:3])
        rates = iter(droppath_rates(cfg))
        for s in range(1, 5):
            i = s - 1
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", OverlapPatchEmbed(patch, stride, ins[i], dims[i]))
            setattr(self, f"block{s}", nn.ModuleList(
                MiTBlock(dims[i], cfg.num_heads[i], cfg.mlp_ratios[i], cfg.sr_ratios[i],
                         cfg.qkv_bias, next(rates))
                for _ in range(cfg.depths[i])))
            setattr(self, f"norm{s}", nn.LayerNorm(dims[i], eps=1e-6))
        self.prompt_generator = PromptGenerator(cfg)
        if cfg.with_flow:
            self.flow_encoder = OpticalFlowEncoder(dims[2], dims[3])
            self.cross_attn_s3 = MotionGuidedCrossAttention(dims[2], cfg.flow_heads)
            self.cross_attn_s4 = MotionGuidedCrossAttention(dims[3], cfg.flow_heads)
        self.head = SegFormerPoolHead(head_cfg, dims)
        g = torch.Generator().manual_seed(seed)
        _init_weights(self, g)
        _init_flax_defaults([self.head] + ([self.cross_attn_s3, self.cross_attn_s4]
                                           if cfg.with_flow else []), g)
        self.eval()
        self.to(device)

    def forward(self, images, segmaps, flow=None, return_features: bool = True):
        from surgical_tpu_torch.models.mit_fused import fused_forward

        return fused_forward(self, images, segmaps, flow, return_features=return_features)

    def graph_forward(self, images, segmaps, flow=None, *, return_features: bool = False,
                      train: bool = False, generator=None, masks=None,
                      capture_attn: bool = False, dtype=torch.float32):
        """The flax module graph (surgical_tpu/models/mit_evp.py:512-597) at
        compute dtype ``dtype`` (parameters stay fp32).

        images, segmaps [B, H, W, 3], flow [B, H, W, 2] or None (any float
        dtype; cast to ``dtype``) -> outputs in ``dtype``: features [B, E]
        with ``return_features``, else (phase logits, anticipation).
        ``train``: DropPath on both branches of every block, dropout at
        ``cfg.drop_rate`` in the blocks and the head's channel dropout,
        BatchNorm from batch statistics; the masks come from ``masks``
        (``models.mit_train.draw_masks``' layout, plus "drop": per block the
        (attention output, MLP hidden, MLP output) keep masks when
        ``cfg.drop_rate`` > 0) or are drawn from ``generator``.

        Returns the outputs alone in eval mode; in train mode (outputs, new
        BatchNorm statistics {module name: (running mean, running var)}, the
        layout of ``models.mit_train.write_bn_stats``). ``capture_attn``
        appends {"block{s}.{d}": attention probabilities [B, heads, N,
        Nkv]}, the counterpart of ``sow("intermediates", "attn")``."""
        cfg, head_cfg = self.cfg, self.head_cfg
        dt = dtype
        x = images.to(dt)
        B = x.shape[0]
        if train and masks is None:
            if generator is None and (cfg.drop_path_rate > 0 or head_cfg.dropout > 0
                                      or cfg.drop_rate > 0):
                raise ValueError("graph_forward in train mode needs a generator or masks for "
                                 "DropPath and dropout")
            masks = draw_masks(cfg, head_cfg, B, generator or torch.Generator())
        dev = x.device
        dp = [tuple(m.to(dev) for m in pair) for pair in masks["droppath"]] if train else None
        drops = masks.get("drop") if train else None

        def block_drops(n: int, blk, N: int, C: int):
            """The block's dropout keep masks: injected, drawn, or none."""
            if not train or cfg.drop_rate == 0.0:
                return None
            if drops is not None:
                return tuple(m.to(dev) for m in drops[n])
            if generator is None:
                raise ValueError("cfg.drop_rate > 0: pass masks['drop'] or a generator")
            keep = 1.0 - cfg.drop_rate
            return tuple((torch.rand(B, N, c, generator=generator, device=generator.device)
                          < keep).to(dev) for c in (C, blk.mlp.fc1.out_features, C))

        pg = self.prompt_generator
        hand = pg.init_prompts(segmaps.to(dt), _ops.FLAX)
        attn_out = {}
        n = 0
        grids = []
        for si in range(4):
            stage = si + 1
            x, H, W = getattr(self, f"patch_embed{stage}")(x, _ops.FLAX)
            C = x.shape[-1]
            tuned = str(stage) in cfg.tuning_stage
            if tuned:
                emb = (_ops.flax_dense(x, getattr(pg, f"embedding_generator{stage}"))
                       if cfg.embedding_tune else None)
            for d, blk in enumerate(getattr(self, f"block{stage}")):
                if tuned:
                    x = pg.get_prompt(x, hand[stage], emb, stage, d)
                x, attn = blk(x, H, W, dp[n] if dp is not None else (None, None),
                              block_drops(n, blk, H * W, C), cfg.drop_rate)
                if capture_attn:
                    attn_out[f"block{stage}.{d}"] = attn
                n += 1
            x = _ops.flax_layernorm(x, getattr(self, f"norm{stage}"))
            grids.append(x.reshape(B, H, W, C))
            x = grids[-1]

        stats = {} if train else None
        if cfg.with_flow and flow is not None:
            fs = {} if train else None
            f3, f4 = self.flow_encoder(flow.to(dt), _ops.FLAX, fs)
            if train:
                stats.update({f"flow_encoder.{k}": v for k, v in fs.items()})
            for idx, ca, ft in ((2, self.cross_attn_s3, f3), (3, self.cross_attn_s4, f4)):
                g = grids[idx]
                grids[idx] = ca(g.reshape(B, -1, g.shape[-1]), ft, _ops.FLAX).reshape(g.shape)

        hs = {} if train else None
        keep = masks["dropout"] if train and head_cfg.dropout > 0.0 else None
        out = self.head(grids, return_features=return_features, ops=_ops.FLAX, bn_stats=hs,
                        keep=keep)
        if train:
            stats.update({f"head.{k}": v for k, v in hs.items()})
        res = (out,) + ((stats,) if train else ()) + ((attn_out,) if capture_attn else ())
        return res[0] if len(res) == 1 else res
