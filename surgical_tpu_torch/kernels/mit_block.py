"""Fused MiT transformer block, its lane-packed stage-1 form and whole-stage
forward, and the frozen-trunk training block: Hopper CUDA kernels
(``csrc/mit_block.cu``) and their plain PyTorch versions.

Port of ``surgical_tpu/kernels/mit_block.py``, whose six Pallas kernels map
onto these wrappers:
- ``fused_mit_block`` serves both ``fused_mit_block`` and
  ``fused_mit_block_hb`` of the JAX package (they compute the same function;
  the latter differs only in its TPU attention schedule);
- ``fused_mit_block_packed2`` serves ``fused_mit_block_packed2``, the
  1-head C = 64 block on image pairs packed into 128-wide rows, with its
  weights from ``pack_weights2``;
- ``fused_mit_stage`` serves ``fused_mit_stage``;
- ``fused_mit_block_train`` is a ``torch.autograd.Function`` over three
  kernels, as the JAX custom VJP is over three Pallas calls: the forward,
  the MLP backward and the attention backward.

A wrapper runs its kernel's plain version only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises. Each wrapper counts
its kernel launches in ``<wrapper>.launches``.

Weight dicts keep the JAX package's layout ([in, out] matrices, dy-major
depthwise taps ``wdw [9, hidden]``, stacked per-depth stage weights with the
same keys and shapes), so the kernels read them as they are.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from surgical_tpu_torch.kernels import _build

HEAD_DIM = 64  # every MiT variant
MAX_KV = 64    # keys per head the attention kernel holds in shared memory
LN_MAX_C = 512  # widest row the LayerNorm stages hold in registers


# -- plain PyTorch versions -------------------------------------------------

def layer_norm(x, scale, bias, eps=1e-6, groups=1):
    """LayerNorm with eps 1e-6 and the biased variance, computed in fp32 and
    rounded to x.dtype: every LayerNorm of the fused graph
    (surgical_tpu mit_block.py::_layernorm, mit_fused.py::_ln). With
    ``groups`` > 1 each of that many equal slices of the last axis is
    normalized on its own (the lane-packed rows, mit_block.py::_ln_packed2)."""
    x32 = x.float().unflatten(-1, (groups, -1))
    m = x32.mean(-1, keepdim=True)
    v = ((x32 - m) ** 2).mean(-1, keepdim=True)
    xn = ((x32 - m) * torch.rsqrt(v + eps)).flatten(-2)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _linear(x, w, b):
    """fp32-accumulated x @ w + b (w in [in, out] layout), kept in fp32."""
    return x.float() @ w.float() + b.float().reshape(-1)


def _attention(q, k, v, heads):
    """Per-image, per-head softmax attention; probabilities rounded to
    q.dtype before P.V, the context rounded to q.dtype."""
    B, N, C = q.shape
    Nkv = k.shape[1]
    hd = C // heads
    qh = q.float().reshape(B, N, heads, hd).transpose(1, 2)
    kh = k.float().reshape(B, Nkv, heads, hd).transpose(1, 2)
    vh = v.float().reshape(B, Nkv, heads, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    return (probs @ vh).transpose(1, 2).reshape(B, N, C).to(q.dtype)


def _dwconv3x3(h, wdw, bdw, H, W):
    """3x3 depthwise conv with zero edges on tokens [B, N, hidden]; fp32
    accumulate in dy-major tap order, + bias, rounded to h.dtype."""
    B, N, Ch = h.shape
    g = F.pad(h.float().reshape(B, H, W, Ch), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, Ch, dtype=torch.float32, device=h.device)
    k = 0
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + g[:, dy:dy + H, dx:dx + W] * wdw[k].float()
            k += 1
    return (acc + bdw.float().reshape(-1)).to(h.dtype).reshape(B, N, Ch)


def _residual(x, branch, m=None):
    """x + branch in fp32 (branch scaled per image by m [B] when given),
    rounded to x.dtype."""
    if m is not None:
        branch = m.float()[:, None, None] * branch
    return (x.float() + branch).to(x.dtype)


def _attn_residual(x, xln, k, v, wq, bq, wo, bo, heads, m=None):
    """x + [m *] out_proj(attention(q_proj(xln), k, v)), rounded to x.dtype."""
    q = _linear(xln, wq, bq).to(x.dtype)
    ctx = _attention(q, k, v, heads)
    return _residual(x, _linear(ctx, wo, bo), m)


def _mlp_residual(x, ln2_scale, ln2_bias, w1, b1, wdw, bdw, w2, b2, H, W, m=None, groups=1):
    """x + [m *] fc2(gelu_tanh(dwconv(fc1(LN2(x))))), with the Pallas body's
    roundings (fc1, dwconv and GELU outputs in x.dtype); LN2 over ``groups``
    slices of the channels."""
    dt = x.dtype
    h = _linear(layer_norm(x, ln2_scale, ln2_bias, groups=groups), w1, b1).to(dt)
    h = _dwconv3x3(h, wdw, bdw, H, W)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    return _residual(x, _linear(h, w2, b2), m)


def fused_mit_block_plain(x, k, v, weights, *, heads, H, W):
    """Plain version of the block kernel (fused_mit_block with LN1 in the
    block, xln=None): x [B, N, C], k/v [B, Nkv, C] -> [B, N, C]."""
    w = weights
    xln = layer_norm(x, w["ln1_scale"], w["ln1_bias"])
    x1 = _attn_residual(x, xln, k, v, w["wq"], w["bq"], w["wo"], w["bo"], heads)
    return _mlp_residual(x1, w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"],
                         w["wdw"], w["bdw"], w["w2"], w["b2"], H, W)


def _pack2(a):
    """[B, n, C] -> [B/2, n, 2C]: row n of pair p is [a[2p, n], a[2p+1, n]]
    (mit_block.py:826-829)."""
    B, n, C = a.shape
    return a.reshape(B // 2, 2, n, C).transpose(1, 2).reshape(B // 2, n, 2 * C)


def _unpack2(a):
    """The inverse of ``_pack2``: [P, n, 2C] -> [2P, n, C]."""
    P, n, C2 = a.shape
    return a.reshape(P, n, 2, C2 // 2).transpose(1, 2).reshape(2 * P, n, C2 // 2)


def _packed2_dims(x, k, packed, H, row_chunks):
    """(B, N, Nkv, hidden) of a packed2 call, raising ValueError where the
    JAX package asserts (mit_block.py:822, 860, 864)."""
    B, N, C = x.shape
    hidden2 = packed["w1"].shape[1]
    if B % 2 or C != HEAD_DIM:
        raise ValueError(f"packed2 takes an even batch of C = {HEAD_DIM} tokens: B={B}, C={C}")
    if hidden2 % 128:
        raise ValueError(f"packed2 takes a packed hidden width that is a multiple of 128, "
                         f"got {hidden2}")
    if row_chunks < 1 or H % row_chunks:
        raise ValueError(f"row_chunks={row_chunks} does not divide H={H}")
    return B, N, k.shape[1], hidden2


def fused_mit_block_packed2_plain(x, k, v, packed, *, H, W, row_chunks=1):
    """Plain version of the packed2 kernel (fused_mit_block_packed2): x [B,
    N, 64], k/v [B, Nkv, 64] (B even), ``packed`` from ``pack_weights2`` or
    any dict of the same shapes -> [B, N, 64]. Each pair of images runs as
    one 128-wide row per token with the bodies' rounding points: LN per
    64-lane half, full 128-wide products, the softmax per image segment (as
    heads = 2 of head_dim 64). ``row_chunks`` > 1 computes the output band by
    band, each band with its one-row dwconv halo above and below
    (_block_kernel_packed2s); every op but the dwconv is row-local, so the
    bands give the whole-grid function."""
    _packed2_dims(x, k, packed, H, row_chunks)
    w = packed
    xp, kp, vp = _pack2(x), _pack2(k), _pack2(v)
    rpc, bands = H // row_chunks, []
    for j in range(row_chunks):
        lo, hi = max(j * rpc - 1, 0), min((j + 1) * rpc + 1, H)  # band rows with halo
        xb = xp[:, lo * W:hi * W]
        xln = layer_norm(xb, w["ln1"][0], w["ln1"][1], groups=2)
        x1 = _attn_residual(xb, xln, kp, vp, w["wq"], w["bq"], w["wo"], w["bo"], heads=2)
        yb = _mlp_residual(x1, w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["wdw"],
                           w["bdw"], w["w2"], w["b2"], hi - lo, W, groups=2)
        bands.append(yb[:, (j * rpc - lo) * W:(j * rpc - lo + rpc) * W])
    return _unpack2(torch.cat(bands, dim=1))


def _sr_patches(x, H, W, sr):
    """[B, N, C] -> [B, (H/sr)*(W/sr), sr*sr*C]: each stride-sr patch's
    tokens in (dy, dx, c) order, the row order of the flattened conv kernel."""
    B, N, C = x.shape
    g = x.reshape(B, H // sr, sr, W // sr, sr, C).permute(0, 1, 3, 2, 4, 5)
    return g.reshape(B, (H // sr) * (W // sr), sr * sr * C)


def fused_mit_stage_plain(x, base, sw, *, heads, H, W, sr):
    """Plain version of the stage kernel: all blocks of one stage, with the
    per-depth prompt add (tanh GELU, as in-kernel), LN1 and the SR/kv path
    inside the stage. x [B, N, C], base [B, N, Cb] or None."""
    dt = x.dtype
    C = x.shape[-1]
    for d in range(sw["wq"].shape[0]):
        if base is not None:
            feat = F.gelu(_linear(base, sw["lww"][d], sw["lwb"][d]),
                          approximate="tanh").to(dt)
            x = (x.float() + _linear(feat, sw["sharedw"], sw["sharedb"])).to(dt)
        xln = layer_norm(x, sw["ln1"][d, 0], sw["ln1"][d, 1])
        kv_in = xln
        if sr > 1:
            red = _linear(_sr_patches(xln, H, W, sr), sw["srw"][d], sw["srb"][d]).to(dt)
            kv_in = layer_norm(red, sw["lnkv"][d, 0], sw["lnkv"][d, 1])
        kv = _linear(kv_in, sw["wkv"][d], sw["bkv"][d]).to(dt)
        x = _attn_residual(x, xln, kv[..., :C], kv[..., C:], sw["wq"][d], sw["bq"][d],
                           sw["wo"][d], sw["bo"][d], heads)
        x = _mlp_residual(x, sw["ln2"][d, 0], sw["ln2"][d, 1], sw["w1"][d], sw["b1"][d],
                          sw["wdw"][d], sw["bdw"][d], sw["w2"][d], sw["b2"][d], H, W)
    return x


# -- training block: plain versions ----------------------------------------
# fused_mit_block_train (surgical_tpu/kernels/mit_block.py:1766) for the
# frozen-trunk recipe: the forward takes xln = LN1(x) as an input, scales
# each residual branch per image by the DropPath factors m1, m2 [B] (0 or
# 1/keep, fp32), and keeps the post-attention residual x1 for the backward.
# The backward gives the input gradients dx, dxln, dk, dv only: the block
# weights are frozen and the masks are data. The plain backward is written
# out with the Pallas bodies' rounding points, not taken by autograd.

def fused_mit_block_train_fwd_plain(x, xln, k, v, weights, m1, m2, *, heads, H, W):
    """Plain version of the train-forward kernel: (y, x1), both [B, N, C]."""
    w = weights
    x1 = _attn_residual(x, xln, k, v, w["wq"], w["bq"], w["wo"], w["bo"], heads, m1)
    y = _mlp_residual(x1, w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["wdw"],
                      w["bdw"], w["w2"], w["b2"], H, W, m2)
    return y, x1


def _gelu_tanh_grad(x32):
    """d/dx of the tanh-form GELU (mit_block.py::_gelu_tanh_grad)."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x32 + 0.044715 * x32 * x32 * x32))
    dinner = c * (1.0 + 3 * 0.044715 * x32 * x32)
    return 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * dinner


def _dwconv3x3_t(g, wdw, H, W):
    """Input gradient of ``_dwconv3x3`` (mit_block.py::_dwconv3x3_T): the
    flipped-tap conv out[y, x] = sum_k g[y - dy_k, x - dx_k] * w_k over the
    in-grid sources, fp32 accumulate in tap order, rounded to g.dtype."""
    B, N, Ch = g.shape
    gp = F.pad(g.float().reshape(B, H, W, Ch), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, Ch, dtype=torch.float32, device=g.device)
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + gp[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W] * wdw[k].float()
            k += 1
    return acc.to(g.dtype).reshape(B, N, Ch)


def _mlp_bwd_plain(h2ln, dmlp, w, *, H, W):
    """Plain version of the MLP-backward kernel: recompute fc1 and the
    dwconv, then dh2ln = dwconv^T((dmlp w2^T) * gelu'(hd)) w1^T in fp32."""
    dt = h2ln.dtype
    a1 = _linear(h2ln, w["w1"], w["b1"]).to(dt)
    hd = _dwconv3x3(a1, w["wdw"], w["bdw"], H, W)
    dh = ((dmlp.float() @ w["w2"].float().t()) * _gelu_tanh_grad(hd.float())).to(dt)
    return _dwconv3x3_t(dh, w["wdw"], H, W).float() @ w["w1"].float().t()


def _attn_bwd_plain(xln, k, v, dx1, m1, w, *, heads):
    """Plain version of the attention-backward kernel: (dxln, dk, dv)."""
    dt = xln.dtype
    B, N, C = xln.shape
    Nkv, hd = k.shape[1], C // heads
    scale = 1.0 / math.sqrt(hd)
    q = _linear(xln, w["wq"], w["bq"]).to(dt)
    dattn = (dx1.float() * m1.float()[:, None, None]).to(dt)
    dctx = (dattn.float() @ w["wo"].float().t()).to(dt)
    split = lambda t, n: t.float().reshape(B, n, heads, hd).transpose(1, 2)
    qh, kh, vh, dch = split(q, N), split(k, Nkv), split(v, Nkv), split(dctx, N)
    P = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    dP = dch @ vh.transpose(-1, -2)
    dv = P.to(dt).float().transpose(-1, -2) @ dch
    dS = (P * (dP - (dP * P).sum(-1, keepdim=True)) * scale).to(dt).float()
    merge = lambda t, n: t.transpose(1, 2).reshape(B, n, C).to(dt)
    dq = merge(dS @ kh, N)
    dxln = (dq.float() @ w["wq"].float().t()).to(dt)
    return dxln, merge(dS.transpose(-1, -2) @ qh, Nkv), merge(dv, Nkv)


def _block_train_bwd(x1, xln, k, v, w, m1, m2, dy, *, heads, H, W, mlp_bwd, attn_bwd):
    """The backward around its two halves (mit_block.py:1665-1760): the
    LayerNorm-2 statistics and backward in plain ops, as the JAX package
    runs them in XLA between its two kernels. (dx, dxln, dk, dv)."""
    dt = x1.dtype
    x32 = x1.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6)
    hhat = (x32 - mu) * inv
    gamma = w["ln2_scale"].float()
    h2ln = (hhat * gamma + w["ln2_bias"].float()).to(dt)
    dy32 = dy.float()
    dmlp = (dy32 * m2.float()[:, None, None]).to(dt)
    dhhat = mlp_bwd(h2ln, dmlp, w, H=H, W=W) * gamma
    mh = dhhat.mean(-1, keepdim=True)
    mh2 = (dhhat * hhat).mean(-1, keepdim=True)
    dx1 = (dy32 + inv * (dhhat - mh - hhat * mh2)).to(dt)
    return (dx1, *attn_bwd(xln, k, v, dx1, m1, w, heads=heads))


def fused_mit_block_train_bwd_plain(x1, xln, k, v, weights, m1, m2, dy, *, heads, H, W):
    """Plain version of the whole backward: (dx, dxln, dk, dv)."""
    return _block_train_bwd(x1, xln, k, v, weights, m1, m2, dy, heads=heads, H=H, W=W,
                            mlp_bwd=_mlp_bwd_plain, attn_bwd=_attn_bwd_plain)


# -- weights ----------------------------------------------------------------

def block_weights_from_params(block, dtype=torch.bfloat16) -> dict:
    """Kernel weights of one port MiT block (``MiTBlock`` module, reference
    key names) in the JAX layout, contiguous, cast to ``dtype``."""
    attn, mlp = block.attn, block.mlp
    dw = mlp.dwconv.dwconv.weight  # [hidden, 1, 3, 3]
    cast = lambda t: t.detach().to(dtype).contiguous()
    return {
        "wq": cast(attn.q.weight.t()), "bq": cast(attn.q.bias),
        "wo": cast(attn.proj.weight.t()), "bo": cast(attn.proj.bias),
        "ln1_scale": cast(block.norm1.weight), "ln1_bias": cast(block.norm1.bias),
        "ln2_scale": cast(block.norm2.weight), "ln2_bias": cast(block.norm2.bias),
        "w1": cast(mlp.fc1.weight.t()), "b1": cast(mlp.fc1.bias),
        "wdw": cast(dw.reshape(dw.shape[0], 9).t()), "bdw": cast(mlp.dwconv.dwconv.bias),
        "w2": cast(mlp.fc2.weight.t()), "b2": cast(mlp.fc2.bias),
    }


def _block_diag2(w):
    """[a, b] -> [2a, 2b] with ``w`` on both diagonal blocks."""
    z = torch.zeros_like(w)
    return torch.cat([torch.cat([w, z], 1), torch.cat([z, w], 1)], 0)


def pack_weights2(weights: dict) -> dict:
    """Per-image block weights -> the packed2 kernel's, with the keys,
    shapes and dtypes of the JAX package's ``pack_weights2``
    (mit_block.py:779-797): ``ln1`` [2, 2C] fp32 (scale, bias), block-diagonal
    wq, wo [2C, 2C], w1 [2C, 2h], w2 [2h, 2C], and every vector doubled."""
    cat = lambda t: torch.cat([t, t], -1)
    return {
        "ln1": torch.stack([cat(weights["ln1_scale"]), cat(weights["ln1_bias"])]).float(),
        "wq": _block_diag2(weights["wq"]), "bq": cat(weights["bq"]),
        "wo": _block_diag2(weights["wo"]), "bo": cat(weights["bo"]),
        "ln2_scale": cat(weights["ln2_scale"]), "ln2_bias": cat(weights["ln2_bias"]),
        "w1": _block_diag2(weights["w1"]), "b1": cat(weights["b1"]),
        "wdw": cat(weights["wdw"]), "bdw": cat(weights["bdw"]),
        "w2": _block_diag2(weights["w2"]), "b2": cat(weights["b2"]),
    }


def stage_weights_from_params(model, stage: int, dtype=torch.bfloat16) -> dict:
    """One stage's per-block weights (+ the per-depth prompt MLPs) of a port
    ``MiTEVP``, stacked on a leading depth axis in the JAX package's
    ``stage_weights_from_params`` layout."""
    blocks = getattr(model, f"block{stage}")
    bws = [block_weights_from_params(b, dtype) for b in blocks]
    cast = lambda t: t.detach().to(dtype).contiguous()
    stack = lambda key: torch.stack([w[key] for w in bws])
    row = lambda key: torch.stack([w[key].reshape(1, -1) for w in bws])
    ln = lambda s, b: torch.stack([torch.stack([w[s], w[b]]) for w in bws])
    out = {
        "ln1": ln("ln1_scale", "ln1_bias"), "ln2": ln("ln2_scale", "ln2_bias"),
        "wq": stack("wq"), "bq": row("bq"), "wo": stack("wo"), "bo": row("bo"),
        "w1": stack("w1"), "b1": row("b1"), "wdw": stack("wdw"), "bdw": row("bdw"),
        "w2": stack("w2"), "b2": row("b2"),
        "wkv": torch.stack([cast(b.attn.kv.weight.t()) for b in blocks]),
        "bkv": torch.stack([cast(b.attn.kv.bias.reshape(1, -1)) for b in blocks]),
    }
    if hasattr(blocks[0].attn, "sr"):
        # torch conv [C, C, sr, sr] -> rows ordered (dy, dx, c_in)
        out["srw"] = torch.stack([
            cast(b.attn.sr.weight.permute(2, 3, 1, 0).reshape(-1, b.attn.sr.weight.shape[0]))
            for b in blocks])
        out["srb"] = torch.stack([cast(b.attn.sr.bias.reshape(1, -1)) for b in blocks])
        out["lnkv"] = torch.stack([
            cast(torch.stack([b.attn.norm.weight, b.attn.norm.bias])) for b in blocks])
    pg = model.prompt_generator
    if hasattr(pg, f"lightweight_mlp{stage}_0"):
        lws = [getattr(pg, f"lightweight_mlp{stage}_{d}")[0] for d in range(len(blocks))]
        shared = getattr(pg, f"shared_mlp{stage}")
        out["lww"] = torch.stack([cast(lw.weight.t()) for lw in lws])
        out["lwb"] = torch.stack([cast(lw.bias.reshape(1, -1)) for lw in lws])
        out["sharedw"] = cast(shared.weight.t())
        out["sharedb"] = cast(shared.bias.reshape(1, -1))
    return out


# -- wrappers -----------------------------------------------------------------

def _ptr(t: torch.Tensor, shape, name: str, dtype=torch.bfloat16) -> int:
    if t.dtype != dtype or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous {dtype} CUDA tensors, got "
                         f"{t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.data_ptr()


# -- launch plans of the serving kernels ------------------------------------
# mit_block_forward and mit_stage_forward take their grids, tile counts and
# shared-memory sizes from these plans; the entry points check each plan
# against the shapes and refuse one that does not fit.

NUM_SMS = 132          # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448   # dynamic shared memory one CTA can have (sm_90)
GEMM_BM, GEMM_BK, GEMM_STAGES = 128, 64, 4  # rows per CTA, K per tile, ring depth
PANEL_MAX_K = 512      # widest A panel kept resident (and LayerNorm'd) in shared memory
ATTN_ROWS = 64         # query rows per attention tile
_SMEM_SLACK = 1024 + 256  # alignment of the 1024-byte swizzle atoms + barriers


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_smem_bytes(K: int, bn: int, resident: bool) -> int:
    """Dynamic shared memory of one ``wgmma_linear`` CTA: the resident A
    panel [128 x K] (or a ring of A tiles), the ring of [64 x bn] weight
    tiles, and the slack for alignment and barriers."""
    a_tiles = _cdiv(K, GEMM_BK) if resident else GEMM_STAGES
    return (a_tiles * GEMM_BM * GEMM_BK * 2 + GEMM_STAGES * GEMM_BK * bn * 2
            + _SMEM_SLACK)


def gemm_plan(M: int, N: int, K: int, *, ln: bool = False) -> tuple:
    """(bn, resident, tiles_per_cta, grid_x, grid_y, smem_bytes) of one
    product out[M, N] = A[M, K] @ W[K, N]. A CTA owns 128 rows and walks
    ``tiles_per_cta`` tiles of ``bn`` columns; with K <= PANEL_MAX_K its A
    panel stays resident, and the LayerNorm prologue (``ln``) needs that.
    Column tiles are split over more CTAs when the row blocks alone would
    not give every SM two CTAs."""
    if M < 1 or N < 1 or K < 1 or N % 8 or K % 8:
        raise ValueError(f"product takes positive M, N, K with N, K multiples of 8: "
                         f"M={M}, N={N}, K={K}")
    resident = K <= PANEL_MAX_K
    if ln and not resident:
        raise ValueError(f"the LayerNorm prologue takes K <= {PANEL_MAX_K}, got {K}")
    bn = 64 if N <= 64 else 128
    ntiles, grid_x = _cdiv(N, bn), _cdiv(M, GEMM_BM)
    split = min(ntiles, max(1, _cdiv(2 * NUM_SMS, grid_x)))
    tpc = _cdiv(ntiles, split)
    smem = gemm_smem_bytes(K, bn, resident)
    if smem > SMEM_LIMIT or _cdiv(ntiles, tpc) > 65535:
        raise ValueError(f"product [{M}, {K}] x [{K}, {N}] does not fit one launch")
    return (bn, int(resident), tpc, grid_x, _cdiv(ntiles, tpc), smem)


def attention_plan(B: int, N: int, heads: int, Nkv: int) -> tuple:
    """(tiles_per_cta, grid_x, grid_y) of the attention kernel: one CTA row
    per (image, head) with its keys staged once, each CTA walking
    ``tiles_per_cta`` query tiles of 64 rows; enough CTAs per (image, head)
    that the grid holds about four per SM."""
    if Nkv < 1 or Nkv > MAX_KV:
        raise ValueError(f"attention takes 1 to {MAX_KV} keys per head, got {Nkv}")
    pairs, qtiles = B * heads, _cdiv(N, ATTN_ROWS)
    if pairs > 65535:
        raise ValueError(f"attention takes at most 65535 (image, head) pairs, got {pairs}")
    split = min(qtiles, max(1, _cdiv(4 * NUM_SMS, pairs)))
    tpc = _cdiv(qtiles, split)
    return (tpc, _cdiv(qtiles, tpc), pairs)


_NO_PLAN = (0,) * 6


def _mlp_plans(M: int, C: int, hidden: int) -> tuple:
    """The out product's plan, then fc1's (LN2 prologue) and fc2's."""
    return (*gemm_plan(M, C, C), *gemm_plan(M, hidden, C, ln=True), *gemm_plan(M, C, hidden))


def block_plan(B: int, H: int, W: int, C: int, heads: int, Nkv: int, hidden: int) -> tuple:
    """The plans of mit_block_forward's launches, flat: the q product (LN1
    prologue), the attention, the out product, fc1 (LN2 prologue), fc2."""
    N = H * W
    return (*gemm_plan(B * N, C, C, ln=True), *attention_plan(B, N, heads, Nkv),
            *_mlp_plans(B * N, C, hidden))


def stage_plan(B: int, H: int, W: int, C: int, heads: int, sr: int, hidden: int,
               Cb: int = 0, C4: int = 0) -> tuple:
    """The plans of mit_stage_forward's launches, flat: the prompt products
    (base @ lww, feat @ sharedw; zeros without a prompt base, Cb = 0), the SR
    product (zeros at sr = 1), kv, q, the attention, then out, fc1, fc2."""
    N, Nkv = H * W, (H // sr) * (W // sr)
    M, Mkv = B * N, B * Nkv
    prompt = ((*gemm_plan(M, C4, Cb), *gemm_plan(M, C, C4)) if Cb else _NO_PLAN * 2)
    srp = gemm_plan(Mkv, C, sr * sr * C) if sr > 1 else _NO_PLAN
    return (*prompt, *srp, *gemm_plan(Mkv, 2 * C, C), *gemm_plan(M, C, C),
            *attention_plan(B, N, heads, Nkv), *_mlp_plans(M, C, hidden))


def _plan_arg(plan):
    """A plan as the C int array the entry points read (kept alive by the
    caller for the call)."""
    return (ctypes.c_int * len(plan))(*plan)


def _check_dims(C, heads, Nkv, hidden, H, W, x):
    if C != heads * HEAD_DIM:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM}: C={C}, heads={heads}")
    if Nkv > MAX_KV:
        raise ValueError(f"kernel takes at most {MAX_KV} keys per head, got {Nkv}")
    if C > LN_MAX_C or hidden % 8:
        raise ValueError(f"kernel takes C <= {LN_MAX_C} and hidden % 8 == 0: {C}, {hidden}")
    if x.shape[1] != H * W:
        raise ValueError(f"token count {x.shape[1]} != H*W = {H * W}")


def fused_mit_block(x, k, v, weights, *, heads: int, H: int, W: int):
    """One MiT block: LN1 -> q -> attention over the precomputed SR k/v ->
    out proj + residual -> LN2 -> fc1 -> 3x3 dwconv -> tanh GELU -> fc2 +
    residual. x [B, N, C], k/v [B, Nkv, C] -> [B, N, C]."""
    if x.device.type == "cpu":
        return fused_mit_block_plain(x, k, v, weights, heads=heads, H=H, W=W)
    if not x.is_cuda:
        raise ValueError(f"fused_mit_block: no kernel for device {x.device}")
    B, N, C = x.shape
    Nkv = k.shape[1]
    hidden = weights["w1"].shape[1]
    _check_dims(C, heads, Nkv, hidden, H, W, x)
    w = weights
    plan = _plan_arg(block_plan(B, H, W, C, heads, Nkv, hidden))
    y = torch.empty_like(x)
    new = lambda width: torch.empty(B * N, width, dtype=x.dtype, device=x.device)
    q, ctx, hid, act = new(C), new(C), new(hidden), new(hidden)
    err = _build.load().mit_block_forward(
        _ptr(x, (B, N, C), "x"), _ptr(k, (B, Nkv, C), "k"), _ptr(v, (B, Nkv, C), "v"),
        _ptr(w["ln1_scale"], (C,), "ln1_scale"), _ptr(w["ln1_bias"], (C,), "ln1_bias"),
        _ptr(w["wq"], (C, C), "wq"), _ptr(w["bq"], (C,), "bq"),
        _ptr(w["wo"], (C, C), "wo"), _ptr(w["bo"], (C,), "bo"),
        _ptr(w["ln2_scale"], (C,), "ln2_scale"), _ptr(w["ln2_bias"], (C,), "ln2_bias"),
        _ptr(w["w1"], (C, hidden), "w1"), _ptr(w["b1"], (hidden,), "b1"),
        _ptr(w["wdw"], (9, hidden), "wdw"), _ptr(w["bdw"], (hidden,), "bdw"),
        _ptr(w["w2"], (hidden, C), "w2"), _ptr(w["b2"], (C,), "b2"), ctypes.addressof(plan),
        q.data_ptr(), ctx.data_ptr(), hid.data_ptr(), act.data_ptr(), y.data_ptr(),
        B, H, W, C, heads, Nkv, hidden, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mit_block_forward")
    fused_mit_block.launches += 1
    return y


fused_mit_block.launches = 0


def fused_mit_block_packed2(x, k, v, packed, *, H: int, W: int, row_chunks: int = 1):
    """The stage-1 block on lane-packed image pairs: x [B, N, 64], k/v [B,
    Nkv, 64] with B even, ``packed`` as ``pack_weights2`` gives it -> [B, N,
    64]. ``row_chunks`` must divide H, as in the JAX package; the kernel
    computes the whole grid at once, which is the same function.

    The kernel reads ``ln1`` in fp32 as given; LN2's scale and bias (in the
    weights' dtype) are converted here to fp32, which is exact."""
    B, N, Nkv, hidden2 = _packed2_dims(x, k, packed, H, row_chunks)
    if x.device.type == "cpu":
        return fused_mit_block_packed2_plain(x, k, v, packed, H=H, W=W, row_chunks=row_chunks)
    if not x.is_cuda:
        raise ValueError(f"fused_mit_block_packed2: no kernel for device {x.device}")
    _check_dims(HEAD_DIM, 1, Nkv, hidden2, H, W, x)
    w, C, C2 = packed, HEAD_DIM, 2 * HEAD_DIM
    ln2 = torch.stack([w["ln2_scale"], w["ln2_bias"]]).float()
    y = torch.empty_like(x)
    new = lambda rows, width: torch.empty(rows, width, dtype=x.dtype, device=x.device)
    M, Mkv = B // 2 * N, B // 2 * Nkv
    xp, q, ctx = new(M, C2), new(M, C2), new(M, C2)
    kp, vp, hid, act = new(Mkv, C2), new(Mkv, C2), new(M, hidden2), new(M, hidden2)
    err = _build.load().mit_block_packed2_forward(
        _ptr(x, (B, N, C), "x"), _ptr(k, (B, Nkv, C), "k"), _ptr(v, (B, Nkv, C), "v"),
        _ptr(w["ln1"], (2, C2), "ln1", torch.float32),
        _ptr(w["wq"], (C2, C2), "wq"), _ptr(w["bq"], (C2,), "bq"),
        _ptr(w["wo"], (C2, C2), "wo"), _ptr(w["bo"], (C2,), "bo"),
        _ptr(ln2, (2, C2), "ln2", torch.float32),
        _ptr(w["w1"], (C2, hidden2), "w1"), _ptr(w["b1"], (hidden2,), "b1"),
        _ptr(w["wdw"], (9, hidden2), "wdw"), _ptr(w["bdw"], (hidden2,), "bdw"),
        _ptr(w["w2"], (hidden2, C2), "w2"), _ptr(w["b2"], (C2,), "b2"),
        xp.data_ptr(), kp.data_ptr(), vp.data_ptr(), q.data_ptr(), ctx.data_ptr(),
        hid.data_ptr(), act.data_ptr(), y.data_ptr(), B, H, W, Nkv, hidden2,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mit_block_packed2_forward")
    fused_mit_block_packed2.launches += 1
    return y


fused_mit_block_packed2.launches = 0


def fused_mit_stage(x, base, sw, *, heads: int, H: int, W: int, sr: int):
    """All blocks of one MiT stage (per block: prompt add from ``base``, LN1,
    SR conv + LN for sr > 1, kv/q projections, attention, MLP).
    x [B, N, C], base [B, N, Cb] or None -> [B, N, C]."""
    if x.device.type == "cpu":
        return fused_mit_stage_plain(x, base, sw, heads=heads, H=H, W=W, sr=sr)
    if not x.is_cuda:
        raise ValueError(f"fused_mit_stage: no kernel for device {x.device}")
    B, N, C = x.shape
    D, _, hidden = sw["w1"].shape
    Nkv = (H // sr) * (W // sr)
    _check_dims(C, heads, Nkv, hidden, H, W, x)
    if H % sr or W % sr:
        raise ValueError(f"grid {H}x{W} is not a multiple of sr={sr}")
    Cb = C4 = 0
    prompt = [None] * 5
    if base is not None:
        Cb, C4 = sw["lww"].shape[1:]
        if C4 % 8 or Cb % 8:
            raise ValueError(f"prompt widths must be multiples of 8: {Cb}, {C4}")
        prompt = [_ptr(base, (B, N, Cb), "base"),
                  _ptr(sw["sharedw"], (C4, C), "sharedw"),
                  _ptr(sw["sharedb"], (1, C), "sharedb"),
                  _ptr(sw["lww"], (D, Cb, C4), "lww"), _ptr(sw["lwb"], (D, 1, C4), "lwb")]
    sr_args = [None] * 3
    if sr > 1:
        sr_args = [_ptr(sw["srw"], (D, sr * sr * C, C), "srw"),
                   _ptr(sw["srb"], (D, 1, C), "srb"), _ptr(sw["lnkv"], (D, 2, C), "lnkv")]
    plan = _plan_arg(stage_plan(B, H, W, C, heads, sr, hidden, Cb, C4))
    y = torch.empty_like(x)
    new = lambda rows, width: torch.empty(rows, max(width, 1), dtype=x.dtype,
                                          device=x.device)
    M, Mkv = B * N, B * Nkv
    xln, feat, q, ctx = new(M, C), new(M, C4), new(M, C), new(M, C)
    patches = new(Mkv, sr * sr * C if sr > 1 else 0)
    red, kvin, kv = new(Mkv, C), new(Mkv, C), new(Mkv, 2 * C)
    hid, act = new(M, hidden), new(M, hidden)
    err = _build.load().mit_stage_forward(
        _ptr(x, (B, N, C), "x"), *prompt, *sr_args,
        _ptr(sw["ln1"], (D, 2, C), "ln1"), _ptr(sw["wkv"], (D, C, 2 * C), "wkv"),
        _ptr(sw["bkv"], (D, 1, 2 * C), "bkv"), _ptr(sw["wq"], (D, C, C), "wq"),
        _ptr(sw["bq"], (D, 1, C), "bq"), _ptr(sw["wo"], (D, C, C), "wo"),
        _ptr(sw["bo"], (D, 1, C), "bo"), _ptr(sw["ln2"], (D, 2, C), "ln2"),
        _ptr(sw["w1"], (D, C, hidden), "w1"), _ptr(sw["b1"], (D, 1, hidden), "b1"),
        _ptr(sw["wdw"], (D, 9, hidden), "wdw"), _ptr(sw["bdw"], (D, 1, hidden), "bdw"),
        _ptr(sw["w2"], (D, hidden, C), "w2"), _ptr(sw["b2"], (D, 1, C), "b2"),
        ctypes.addressof(plan), y.data_ptr(), xln.data_ptr(), feat.data_ptr(),
        patches.data_ptr(), red.data_ptr(), kvin.data_ptr(), kv.data_ptr(), q.data_ptr(),
        ctx.data_ptr(), hid.data_ptr(), act.data_ptr(), B, H, W, C, heads, sr, D, Cb, C4, hidden,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mit_stage_forward")
    fused_mit_stage.launches += 1
    return y


fused_mit_stage.launches = 0


def block_train_forward(x, xln, k, v, weights, m1, m2, *, heads: int, H: int, W: int):
    """The train-forward kernel: (y, x1) from x, xln = LN1(x) [B, N, C], k/v
    [B, Nkv, C] and the DropPath factors m1, m2 [B] (fp32)."""
    if x.device.type == "cpu":
        return fused_mit_block_train_fwd_plain(x, xln, k, v, weights, m1, m2,
                                               heads=heads, H=H, W=W)
    if not x.is_cuda:
        raise ValueError(f"block_train_forward: no kernel for device {x.device}")
    B, N, C = x.shape
    Nkv = k.shape[1]
    hidden = weights["w1"].shape[1]
    _check_dims(C, heads, Nkv, hidden, H, W, x)
    w = weights
    y, x1 = torch.empty_like(x), torch.empty_like(x)
    new = lambda width: torch.empty(B * N, width, dtype=x.dtype, device=x.device)
    q, ctx, hid, act = new(C), new(C), new(hidden), new(hidden)
    err = _build.load().mit_block_train_forward(
        _ptr(x, (B, N, C), "x"), _ptr(xln, (B, N, C), "xln"),
        _ptr(k, (B, Nkv, C), "k"), _ptr(v, (B, Nkv, C), "v"),
        _ptr(m1, (B,), "m1", torch.float32), _ptr(m2, (B,), "m2", torch.float32),
        _ptr(w["wq"], (C, C), "wq"), _ptr(w["bq"], (C,), "bq"),
        _ptr(w["wo"], (C, C), "wo"), _ptr(w["bo"], (C,), "bo"),
        _ptr(w["ln2_scale"], (C,), "ln2_scale"), _ptr(w["ln2_bias"], (C,), "ln2_bias"),
        _ptr(w["w1"], (C, hidden), "w1"), _ptr(w["b1"], (hidden,), "b1"),
        _ptr(w["wdw"], (9, hidden), "wdw"), _ptr(w["bdw"], (hidden,), "bdw"),
        _ptr(w["w2"], (hidden, C), "w2"), _ptr(w["b2"], (C,), "b2"),
        q.data_ptr(), ctx.data_ptr(), hid.data_ptr(), act.data_ptr(), x1.data_ptr(),
        y.data_ptr(), B, H, W, C, heads, Nkv, hidden,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mit_block_train_forward")
    block_train_forward.launches += 1
    return y, x1


block_train_forward.launches = 0


def block_train_mlp_backward(h2ln, dmlp, weights, *, H: int, W: int):
    """The MLP-backward kernel: dh2ln [B, N, C] fp32 from h2ln = LN2(x1) and
    dmlp = m2 * dy (both [B, N, C])."""
    if h2ln.device.type == "cpu":
        return _mlp_bwd_plain(h2ln, dmlp, weights, H=H, W=W)
    if not h2ln.is_cuda:
        raise ValueError(f"block_train_mlp_backward: no kernel for device {h2ln.device}")
    B, N, C = h2ln.shape
    hidden = weights["w1"].shape[1]
    if C % 8 or hidden % 8 or N != H * W:
        raise ValueError(f"kernel takes C % 8 == hidden % 8 == 0 and N == H*W: "
                         f"C={C}, hidden={hidden}, N={N}, H={H}, W={W}")
    w = weights
    buf_a, buf_b = (torch.empty(B * N, hidden, dtype=h2ln.dtype, device=h2ln.device)
                    for _ in range(2))
    dh2ln = torch.empty(B, N, C, dtype=torch.float32, device=h2ln.device)
    err = _build.load().mit_block_train_mlp_backward(
        _ptr(h2ln, (B, N, C), "h2ln"), _ptr(dmlp, (B, N, C), "dmlp"),
        _ptr(w["w1"], (C, hidden), "w1"), _ptr(w["b1"], (hidden,), "b1"),
        _ptr(w["wdw"], (9, hidden), "wdw"), _ptr(w["bdw"], (hidden,), "bdw"),
        _ptr(w["w2"], (hidden, C), "w2"), buf_a.data_ptr(), buf_b.data_ptr(),
        dh2ln.data_ptr(), B, H, W, C, hidden, torch.cuda.current_stream(h2ln.device).cuda_stream)
    _build.check(err, "mit_block_train_mlp_backward")
    block_train_mlp_backward.launches += 1
    return dh2ln


block_train_mlp_backward.launches = 0


def block_train_attn_backward(xln, k, v, dx1, m1, weights, *, heads: int):
    """The attention-backward kernel: (dxln, dk, dv) from xln, k, v, the
    residual gradient dx1 [B, N, C] and m1 [B]."""
    if xln.device.type == "cpu":
        return _attn_bwd_plain(xln, k, v, dx1, m1, weights, heads=heads)
    if not xln.is_cuda:
        raise ValueError(f"block_train_attn_backward: no kernel for device {xln.device}")
    B, N, C = xln.shape
    Nkv = k.shape[1]
    if C != heads * HEAD_DIM or Nkv > MAX_KV or C % 8:
        raise ValueError(f"kernel takes head_dim {HEAD_DIM}, at most {MAX_KV} keys and "
                         f"C % 8 == 0: C={C}, heads={heads}, Nkv={Nkv}")
    w = weights
    q, dctx, dq, dxln = (torch.empty_like(xln) for _ in range(4))
    dk_ws, dv_ws = (torch.zeros(B, Nkv, C, dtype=torch.float32, device=xln.device)
                    for _ in range(2))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().mit_block_train_attn_backward(
        _ptr(xln, (B, N, C), "xln"), _ptr(k, (B, Nkv, C), "k"), _ptr(v, (B, Nkv, C), "v"),
        _ptr(dx1, (B, N, C), "dx1"), _ptr(m1, (B,), "m1", torch.float32),
        _ptr(w["wq"], (C, C), "wq"), _ptr(w["bq"], (C,), "bq"), _ptr(w["wo"], (C, C), "wo"),
        q.data_ptr(), dctx.data_ptr(), dq.data_ptr(), dk_ws.data_ptr(), dv_ws.data_ptr(),
        dxln.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, C, heads, Nkv,
        torch.cuda.current_stream(xln.device).cuda_stream)
    _build.check(err, "mit_block_train_attn_backward")
    block_train_attn_backward.launches += 1
    return dxln, dk, dv


block_train_attn_backward.launches = 0


class _FusedBlockTrain(torch.autograd.Function):
    """The JAX custom VJP ``_fused_block_train`` (mit_block.py:1608-1763):
    the forward kernel saves x1; the backward runs the MLP-backward kernel,
    the plain LayerNorm-2 backward, then the attention-backward kernel."""

    @staticmethod
    def forward(ctx, x, xln, k, v, m1, m2, weights, heads, H, W):
        y, x1 = block_train_forward(x, xln, k, v, weights, m1, m2, heads=heads, H=H, W=W)
        ctx.save_for_backward(x1, xln, k, v, m1, m2)
        ctx.weights, ctx.dims = weights, (heads, H, W)
        return y

    @staticmethod
    def backward(ctx, dy):
        x1, xln, k, v, m1, m2 = ctx.saved_tensors
        heads, H, W = ctx.dims
        dx, dxln, dk, dv = _block_train_bwd(
            x1, xln, k, v, ctx.weights, m1, m2, dy.contiguous(), heads=heads, H=H, W=W,
            mlp_bwd=block_train_mlp_backward, attn_bwd=block_train_attn_backward)
        # frozen weights and data masks: no gradient (JAX returns zeros there)
        return dx, dxln, dk, dv, None, None, None, None, None, None


def fused_mit_block_train(x, xln, k, v, weights, m1, m2, *, heads: int, H: int, W: int):
    """Differentiable MiT block for frozen-trunk training: x [B, N, C], xln =
    LN1(x), k/v [B, Nkv, C], DropPath factors m1, m2 [B] -> y [B, N, C].
    Gradients reach x, xln, k and v; the block weights get none."""
    return _FusedBlockTrain.apply(x, xln, k, v, m1, m2, weights, heads, H, W)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    fused_mit_block.launches = 0
    fused_mit_block_packed2.launches = 0
    fused_mit_stage.launches = 0
    block_train_forward.launches = 0
    block_train_mlp_backward.launches = 0
    block_train_attn_backward.launches = 0
