"""Plain fp32 reference of the prompted MiT backbone with flow fusion and the
pooled SegFormer head (SegFormer arXiv:2105.15203, EVP arXiv:2303.10883).

Written from the published equations over a state dict in the reference
checkpoints' key names (``patch_embed{s}.proj``, ``block{s}.{d}.attn.q``,
``prompt_generator.lightweight_mlp{s}_{d}.0``, ``flow_encoder.bn{i}``,
``cross_attn_s3.cross_attn.in_proj_weight``, ``head.linear_fuse.conv``, ...).
It imports nothing of the program: every weight it reads is the state dict
the benchmark drew from the seed, and it works out every derived layout
itself. fp32 throughout; the caller turns TF32 off.

``quant``, when given, is applied to both operands of every product and
convolution: the control of ``correct`` passes an fp8 rounding here.

The configuration is the benchmark's own JSON dict, not the program's
dataclass. The semantics follow the system under test where it chooses:
the serving graph's MLP GELU is the tanh form and the training graph's the
exact erf (``mlp_gelu``); stage 4's prompt GELU is the tanh form where the
serving graph runs the whole-stage kernel (``stage4_prompt_gelu``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CHOLEC80_MEAN = (0.41757566, 0.26098573, 0.25888634)
CHOLEC80_STD = (0.21938758, 0.1983, 0.19342837)
LN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.99  # flax's, which the program follows


def _q(x, quant):
    return x if quant is None else quant(x)


def linear(x, sd, name, quant=None):
    return F.linear(_q(x, quant), _q(sd[name + ".weight"], quant), sd.get(name + ".bias"))


def conv2d(x, sd, name, stride, pad, groups=1, quant=None):
    """NHWC convolution with a torch-layout weight [out, in / groups, kh, kw]."""
    y = F.conv2d(_q(x.permute(0, 3, 1, 2), quant), _q(sd[name + ".weight"], quant),
                 sd.get(name + ".bias"), stride, pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def layernorm(x, sd, name):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"], sd[name + ".bias"], LN_EPS)


def gelu(x, form):
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def attention(q, k, v, heads, quant=None):
    """Softmax attention per head: q [B, N, C], k, v [B, M, C]."""
    B, N, C = q.shape
    hd = C // heads
    qh = q.reshape(B, N, heads, hd).transpose(1, 2)
    kh = k.reshape(B, -1, heads, hd).transpose(1, 2)
    vh = v.reshape(B, -1, heads, hd).transpose(1, 2)
    s = _q(qh, quant) @ _q(kh, quant).transpose(-1, -2) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    return (_q(p, quant) @ _q(vh, quant)).transpose(1, 2).reshape(B, N, C)


def batchnorm(x, sd, name, train, stats):
    """NHWC BatchNorm: running statistics in eval mode; in train mode the
    batch's (biased variance), the new running statistics into ``stats``."""
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    if not train:
        inv = torch.rsqrt(sd[name + ".running_var"] + BN_EPS)
        return (x - sd[name + ".running_mean"]) * inv * w + b
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), unbiased=False)
    with torch.no_grad():
        stats[name + ".running_mean"] = (BN_MOMENTUM * sd[name + ".running_mean"]
                                         + (1 - BN_MOMENTUM) * mean)
        stats[name + ".running_var"] = (BN_MOMENTUM * sd[name + ".running_var"]
                                        + (1 - BN_MOMENTUM) * var)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w + b


def patch_embed(x, sd, name, patch, stride, quant):
    y = conv2d(x, sd, name + ".proj", stride, patch // 2, quant=quant)
    B, H, W, C = y.shape
    return layernorm(y.reshape(B, H * W, C), sd, name + ".norm"), H, W


def gaussian_blur_5x5(x):
    """Binomial 5x5 blur, reflect padding, depthwise: x [B, H, W, C]."""
    k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device)
    C = x.shape[-1]
    kern = (torch.outer(k1, k1) / 256.0).expand(C, 1, 5, 5)
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect")
    return F.conv2d(xp, kern, groups=C).permute(0, 2, 3, 1)


def block(x, sd, p, H, W, heads, sr, mlp_gelu, droppath=None, quant=None):
    """One pre-LN block: spatial-reduction attention, then the Mix-FFN
    (fc1, 3x3 depthwise conv, GELU, fc2); ``droppath`` the two branches'
    per-image factors."""
    B, N, C = x.shape
    xln = layernorm(x, sd, p + "norm1")
    q = linear(xln, sd, p + "attn.q", quant)
    kv_in = xln
    if sr > 1:
        red = conv2d(xln.reshape(B, H, W, C), sd, p + "attn.sr", sr, 0, quant=quant)
        kv_in = layernorm(red.reshape(B, -1, C), sd, p + "attn.norm")
    kv = linear(kv_in, sd, p + "attn.kv", quant)
    a = linear(attention(q, kv[..., :C], kv[..., C:], heads, quant), sd, p + "attn.proj", quant)
    if droppath is not None:
        a = a * droppath[0][:, None, None]
    x = x + a
    h = linear(layernorm(x, sd, p + "norm2"), sd, p + "mlp.fc1", quant)
    hid = h.shape[-1]
    h = conv2d(h.reshape(B, H, W, hid), sd, p + "mlp.dwconv.dwconv", 1, 1, groups=hid,
               quant=quant).reshape(B, N, hid)
    h = linear(gelu(h, mlp_gelu), sd, p + "mlp.fc2", quant)
    if droppath is not None:
        h = h * droppath[1][:, None, None]
    return x + h


def flow_encoder(flow, sd, train, stats, quant):
    """Four conv-BN-ReLU layers over the flow (strides 4, 2, 2, 2): the
    stage-3 and stage-4 token sequences."""
    h, outs = flow, []
    for i, (k, s) in enumerate(((7, 4), (3, 2), (3, 2), (3, 2)), start=1):
        h = conv2d(h, sd, f"flow_encoder.conv{i}", s, k // 2, quant=quant)
        h = torch.relu(batchnorm(h, sd, f"flow_encoder.bn{i}", train, stats))
        outs.append(h)
    B = flow.shape[0]
    return outs[2].reshape(B, -1, outs[2].shape[-1]), outs[3].reshape(B, -1, outs[3].shape[-1])


def cross_attention(xv, xf, sd, p, heads, quant):
    """Visual queries against flow keys and values, residual, LayerNorm."""
    C = xv.shape[-1]
    w, b = sd[p + "cross_attn.in_proj_weight"], sd[p + "cross_attn.in_proj_bias"]
    proj = lambda x, i: F.linear(_q(x, quant), _q(w[i * C:(i + 1) * C], quant),
                                 b[i * C:(i + 1) * C])
    o = attention(proj(xv, 0), proj(xf, 1), proj(xf, 2), heads, quant)
    return layernorm(xv + linear(o, sd, p + "cross_attn.out_proj", quant), sd, p + "norm")


def head(grids, sd, head_cfg, train, stats, keep, quant, return_features):
    """Per-stage projections of the grids resized to stage 4's, fused by a
    1x1 conv, BN, ReLU, (channel dropout), mean pool; then the phase and
    anticipation MLPs."""
    target = grids[3].shape[1:3]
    parts = []
    for i in (4, 3, 2, 1):
        g = grids[i - 1]
        if g.shape[1:3] != target:
            g = F.interpolate(g.permute(0, 3, 1, 2), size=tuple(target), mode="bilinear",
                              align_corners=False, antialias=False).permute(0, 2, 3, 1)
        parts.append(linear(g, sd, f"head.linear_c{i}.proj", quant))
    h = conv2d(torch.cat(parts, dim=-1), sd, "head.linear_fuse.conv", 1, 0, quant=quant)
    h = torch.relu(batchnorm(h, sd, "head.linear_fuse.bn", train, stats))
    if keep is not None:
        h = torch.where(keep[:, None, None, :], h / (1.0 - head_cfg["dropout"]),
                        torch.zeros_like(h))
    feat = h.mean(dim=(1, 2))
    if return_features:
        return feat
    mlp = lambda n: linear(torch.relu(linear(feat, sd, f"head.{n}.0", quant)), sd,
                           f"head.{n}.2", quant)
    return mlp("fc"), mlp("fc_ant")


def forward(sd, cfg, head_cfg, img, seg, flow, *, mlp_gelu="tanh", stage4_prompt_gelu="erf",
            train=False, masks=None, quant=None, return_features=True):
    """The backbone and head in fp32: img, seg [B, H, W, 3] normalized, flow
    [B, H, W, 2] or None -> pooled features [B, E], or (phase logits,
    anticipation). In train mode BatchNorm takes the batch's statistics and
    ``masks`` gives the DropPath factors ({"droppath": [(m1, m2) per block],
    "dropout": [B, E] keep mask}); returns (outputs, new running
    statistics)."""
    dims, heads, depths, srs = (cfg["embed_dims"], cfg["num_heads"], cfg["depths"],
                                cfg["sr_ratios"])
    stats = {}
    prev, hand = gaussian_blur_5x5(seg), {}
    for s in range(1, 5):
        patch, stride = (7, 4) if s == 1 else (3, 2)
        tok, H, W = patch_embed(prev, sd, f"prompt_generator.handcrafted_generator{s}", patch,
                                stride, quant)
        hand[s] = tok
        prev = tok.reshape(tok.shape[0], H, W, -1)
    x, grids, n = img, [], 0
    B = img.shape[0]
    for s in range(1, 5):
        patch, stride = (7, 4) if s == 1 else (3, 2)
        x, H, W = patch_embed(x, sd, f"patch_embed{s}", patch, stride, quant)
        base = hand[s] + linear(x, sd, f"prompt_generator.embedding_generator{s}", quant)
        form = stage4_prompt_gelu if s == 4 else "erf"
        for d in range(depths[s - 1]):
            feat = gelu(linear(base, sd, f"prompt_generator.lightweight_mlp{s}_{d}.0", quant), form)
            x = x + linear(feat, sd, f"prompt_generator.shared_mlp{s}", quant)
            dp = masks["droppath"][n] if train else None
            x = block(x, sd, f"block{s}.{d}.", H, W, heads[s - 1], srs[s - 1], mlp_gelu, dp, quant)
            n += 1
        x = layernorm(x, sd, f"norm{s}")
        grids.append(x.reshape(B, H, W, -1))
        x = grids[-1]
    if cfg["with_flow"] and flow is not None:
        f3, f4 = flow_encoder(flow, sd, train, stats, quant)
        for idx, name, ft in ((2, "cross_attn_s3.", f3), (3, "cross_attn_s4.", f4)):
            g = grids[idx]
            grids[idx] = cross_attention(g.reshape(B, -1, g.shape[-1]), ft, sd, name,
                                         cfg["flow_heads"], quant).reshape(g.shape)
    keep = masks.get("dropout") if train and masks else None
    out = head(grids, sd, head_cfg, train, stats, keep, quant, return_features)
    return (out, stats) if train else out


# -- wire format and augmentation ------------------------------------------------

def normalize(x):
    mean = torch.tensor(CHOLEC80_MEAN, device=x.device)
    std = torch.tensor(CHOLEC80_STD, device=x.device)
    return (x - mean) / std


def dequant(img_u8, seg_u8, flow_f16):
    """Wire batch -> normalized fp32 images and segmaps (the segmap
    broadcast to 3 channels) and fp32 flow."""
    img = normalize(img_u8.float() / 255.0)
    seg = normalize((seg_u8.float() / 255.0).expand(img.shape))
    return img, seg, None if flow_f16 is None else flow_f16.float()


def _gray(img):
    return img @ torch.tensor((0.299, 0.587, 0.114), device=img.device)


def _adjust_hue(img, shift):
    """Hue rotation through HSV (torchvision's formulas)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc, minc = img.amax(-1), img.amin(-1)
    d = maxc - minc
    s = torch.where(maxc > 0, d / maxc.clamp_min(1e-12), torch.zeros_like(d))
    dn = d.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / dn, (maxc - g) / dn, (maxc - b) / dn
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    h = torch.remainder(h + shift[:, None, None], 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    v = maxc
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)[..., None]
    pick = lambda *c: torch.gather(torch.stack(c, -1), -1, i)[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], -1)


def rotation_tables(size, degrees):
    """Nearest-neighbour source index of every pixel for each integer angle
    in [-degrees, degrees], size * size for a pixel from outside the frame."""
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
                         indexing="ij")
    c = (size - 1) / 2.0
    out = []
    for a in range(-degrees, degrees + 1):
        r = np.deg2rad(a)
        xs = np.round((xx - c) * np.cos(r) + (yy - c) * np.sin(r) + c).astype(np.int64)
        ys = np.round(-(xx - c) * np.sin(r) + (yy - c) * np.cos(r) + c).astype(np.int64)
        inside = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        flat = np.clip(ys, 0, size - 1) * size + np.clip(xs, 0, size - 1)
        out.append(np.where(inside, flat, size * size).reshape(-1))
    return np.stack(out)


def augment(img_u8, seg_u8, flow_f16, params, crop, degrees):
    """The training stack on a wire batch at the resize size, with given
    per-image parameters (crop_xy, flip, angle_deg, brightness, contrast,
    saturation, hue): crop, colour jitter, horizontal flip, rotation by a
    whole angle (nearest, zero fill; flow vectors rotated and u negated on a
    flip), normalize. Returns fp32 (img, seg, flow) at ``crop``."""
    crop_xy, flip, angle, bright, contr, satur, hue = params
    B, dev = img_u8.shape[0], img_u8.device
    ar = torch.arange(crop, device=dev)
    rows = (crop_xy[:, 1, None] + ar)[:, :, None]
    cols = (crop_xy[:, 0, None] + ar)[:, None, :]
    cut = lambda x: x[torch.arange(B, device=dev)[:, None, None], rows, cols]
    img = cut(img_u8.float() / 255.0)
    seg = cut((seg_u8.float() / 255.0).expand(*seg_u8.shape[:3], 3))
    per = lambda f: f.reshape(-1, 1, 1, 1)
    img = (img * per(bright)).clamp(0, 1)
    img = (per(contr) * img + (1 - per(contr)) * _gray(img).mean(dim=(-2, -1)).reshape(-1, 1, 1, 1)
           ).clamp(0, 1)
    img = (per(satur) * img + (1 - per(satur)) * _gray(img)[..., None]).clamp(0, 1)
    img = _adjust_hue(img, hue)
    fl = flow_f16.float() if flow_f16 is not None else None
    mirror = lambda x: torch.where(flip[:, None, None, None], x.flip(2), x)
    img, seg = mirror(img), mirror(seg)
    if fl is not None:
        fl = cut(fl)
        mirrored = fl.flip(2) * torch.tensor([-1.0, 1.0], device=dev)
        fl = torch.where(flip[:, None, None, None], mirrored, fl)
    idx = torch.from_numpy(rotation_tables(crop, degrees)).to(dev)[angle.long() + degrees]

    def rot(x):
        xf = x.reshape(B, crop * crop, -1)
        xf = torch.cat([xf, xf.new_zeros(B, 1, xf.shape[-1])], 1)
        return torch.gather(xf, 1, idx[:, :, None].expand(-1, -1, xf.shape[-1])).reshape(x.shape)

    img, seg = normalize(rot(img)), normalize(rot(seg))
    if fl is not None:
        fl = rot(fl)
        rad = angle.float() * (math.pi / 180.0)
        cos, sin = torch.cos(rad)[:, None, None], torch.sin(rad)[:, None, None]
        u, v = fl[..., 0], fl[..., 1]
        fl = torch.stack([u * cos - v * sin, u * sin + v * cos], -1)
    return img, seg, fl


def backbone_loss(logits, ant_pred, labels, ant):
    """Sum-reduction cross-entropy plus sum-reduction smooth L1 (beta 1)."""
    ce = F.cross_entropy(logits, labels, reduction="sum")
    return ce + F.smooth_l1_loss(ant_pred, ant, reduction="sum", beta=1.0)
