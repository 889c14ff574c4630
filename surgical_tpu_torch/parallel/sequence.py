"""Sequence parallelism for the causal temporal models: time split over ranks.

Port of ``surgical_tpu/parallel/sequence.py`` on ``torch.distributed``.
Every function takes the whole video on every rank (as JAX's ``shard_map``
takes the global array), runs this rank's contiguous chunk of T / world
frames, and returns the whole output, gathered in rank order. The frames
left of a chunk come from the ranks before it through ``_gather_left``,
as many chunks back as the context needs; before the first frame there
are zeros, as ``ppermute`` fills the left edge.

- ``sp_mstcn_infer`` exchanges a halo per dilated layer: each conv fetches
  its own 2 * dilation frames, so the zeros before the video coincide with
  that layer's causal padding and the result is the single-device output
  (prepending zero input frames instead would not be exact: biases turn
  them into nonzero activations in later layers).
- ``sp_mamba_infer``: the depthwise causal conv exchanges a d_conv - 1
  halo; the selective scan carries unbounded context, so each rank scans
  its chunk from a zero state (``kernels/selective_scan.py``: the Hopper
  kernel on the card) and the true incoming state comes from an
  all-gather of every chunk's affine map: over a chunk the recurrence
  h_t = a_t h_{t-1} + b_t composes to h_out = A_prod h_in + h_fin with
  A_prod = exp(sum_t dt_t A), so the ranks before this one compose to its
  h_in, and y_t += <exp(cumsum(dt)_t A) h_in, C_t> corrects the outputs
  (fp32, the closed forms of JAX's ``_sp_selective_scan``).
- ``sequence_parallel_infer`` is the generic input-halo helper for causal
  functions whose before-the-start semantics is zero input frames.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from surgical_tpu_torch.kernels import selective_scan as scan_kernel
from surgical_tpu_torch.models.mamba import causal_depthwise_conv
from surgical_tpu_torch.parallel.mesh import all_gather, rank_world


def mstcn_left_context(stages: int, layers: int) -> int:
    """Exact causal receptive field of the stacked dilated TCN: each stage's
    L layers (k=3, dilation 2^l, left pad 2 * 2^l) see 2 (2^L - 1) frames
    back; the stages compose additively."""
    return stages * 2 * (2 ** layers - 1)


def _chunk(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of the leading (time) axis; T must divide."""
    rank, world = rank_world(group)
    T = x.shape[0]
    if T % world:
        raise ValueError(f"T = {T} frames do not divide over {world} ranks")
    Tl = T // world
    return x[rank * Tl:(rank + 1) * Tl]


def _gather_left(x: torch.Tensor, n_frames: int, group=None) -> torch.Tensor:
    """The ``n_frames`` frames before this rank's chunk ``x`` [Tl, ...]
    (time first): [n_frames, ...], zeros before the first frame. Each rank
    contributes its last min(n_frames, Tl) frames to one all-gather; a halo
    longer than a chunk takes whole chunks from as many ranks back as it
    needs."""
    rank, _ = rank_world(group)
    Tl = x.shape[0]
    k = min(n_frames, Tl)
    tails = all_gather(x[Tl - k:], group)         # [world * k, ...], rank order
    hops = -(-n_frames // Tl)
    lo = rank - hops
    parts = [tails[max(lo, 0) * k:rank * k]]
    if lo < 0:
        parts.insert(0, x.new_zeros((-lo * k, *x.shape[1:])))
    return torch.cat(parts)[-n_frames:]


@torch.no_grad()
def sp_mstcn_infer(model, lfb: torch.Tensor, group=None) -> torch.Tensor:
    """Time-sharded ``MultiStageTCN`` inference: lfb [T, f_dim] -> [S, T,
    out], the single-device ``model(lfb[None])[:, 0]`` in eval mode, with
    every dilated conv's left pad exchanged as a halo. Causal models only;
    T must divide over the group."""
    cfg = model.cfg
    if not cfg.causal:
        raise ValueError("sequence parallelism requires the causal MS-TCN")
    x = _chunk(lfb, group).t()[None]               # [1, f_dim, Tl]
    outs = []
    for stage in (model.stage1_phase, *model.stages):
        h = stage.conv_1x1(x)
        for layer in stage.layers:
            halo = _gather_left(h[0].t(), 2 * layer.dilation, group).t()[None]
            y = layer.conv_1x1(torch.relu(layer.conv_dilated(torch.cat([halo, h], dim=-1))))
            h = h + y
        out = stage.conv_out_classes(h)
        outs.append(out)
        x = torch.softmax(out, dim=1)
    local = torch.stack(outs)[:, 0].transpose(1, 2)  # [S, Tl, out]
    return all_gather(local, group, dim=1)


def _sp_selective_scan(x, dt, A, B, C, D, group=None):
    """The selective scan of one video split over time, exact up to fp32
    reassociation: x, dt [1, Tl, D]; A [D, N]; B, C [1, Tl, N]; D [D], all
    fp32, this rank's chunk. A local scan from a zero state, then the
    incoming state from the ranks before and its closed-form correction."""
    rank, _ = rank_world(group)
    y = scan_kernel.selective_scan(x, dt, A, B, C, D)   # zero initial state
    dt0, x0, B0 = dt[0], x[0], B[0]
    cs = torch.cumsum(dt0, dim=0)                        # [Tl, D] inclusive
    total = cs[-1]
    # this chunk's map from a zero state: h_out = A_prod * h_in + h_fin,
    # h_fin = sum_t exp((cs_T - cs_t) A) dt_t x_t B_t
    a_prod = torch.exp(total[:, None] * A)               # [D, N]
    b = (dt0 * x0)[:, :, None] * B0[:, None, :]           # [Tl, D, N]
    h_fin = (torch.exp((total[None] - cs)[:, :, None] * A[None]) * b).sum(0)
    maps = all_gather(torch.stack([a_prod, h_fin])[None], group)  # [world, 2, D, N]
    h_in = torch.zeros_like(h_fin)
    for k in range(rank):                                 # compose ranks 0..rank-1 in order
        h_in = maps[k, 0] * h_in + maps[k, 1]
    carry = torch.exp(cs[:, :, None] * A[None]) * h_in[None]  # [Tl, D, N]
    return y + torch.einsum("tdn,tn->td", carry, C[0])[None]


def _sp_mamba_block(block, u, group):
    """``MambaBlock.forward`` on this rank's chunk u [1, Tl, d_model], the
    conv's left pad and the scan's state exchanged over the group."""
    cfg = block.cfg
    x, z = block.in_proj(u).chunk(2, dim=-1)
    left = _gather_left(x[0], cfg.d_conv - 1, group)[None]
    x = F.silu(causal_depthwise_conv(x, block.conv1d.weight, block.conv1d.bias, left=left))
    dt, B, C = block.ssm_inputs(x)
    A = -torch.exp(block.A_log.float())
    f32 = lambda t: t.float().contiguous()
    y = _sp_selective_scan(f32(x), f32(dt), A.contiguous(), f32(B), f32(C), f32(block.D),
                           group).to(u.dtype)
    return block.out_proj(y * F.silu(z))


@torch.no_grad()
def sp_mamba_infer(model, x: torch.Tensor, group=None) -> torch.Tensor:
    """Time-sharded ``CausalMambaModel`` inference: x [T, f_dim] -> [T,
    out], the single-device ``model(x[None])[0, 0]`` in eval mode up to fp32
    reassociation (the same LayerNorm eps 1e-6 and softplus, the model's own
    modules). T must divide over the group."""
    h = model.in_proj(_chunk(x, group)[None])
    for block in model.blocks:
        h = h + _sp_mamba_block(block, h, group)
    return all_gather(model.head(model.norm(h))[0], group)


def sequence_parallel_infer(apply_fn: Callable[[Any], torch.Tensor], inputs: Any,
                            halo: int, group=None, *, time_axis: int = -2) -> torch.Tensor:
    """Run a causal ``apply_fn`` over time-split inputs with an INPUT halo.

    Exact only for functions whose before-the-start semantics is zero input
    frames: out[t] = f(in[t - halo .. t]) with zero extension (not for
    networks with a causal pad per layer: those exchange per layer, as
    ``sp_mstcn_infer`` does). ``inputs``: a tuple, dict or any pytree of
    tensors with a leading time axis of T frames (T divides over the
    group). ``apply_fn`` maps the pytree of this rank's halo + T / world
    frames to a tensor whose ``time_axis`` has that extended length; the
    result is the whole [..., T, ...] output, gathered on every rank."""
    leaves, spec = tree_flatten(inputs)
    T = leaves[0].shape[0]
    if any(leaf.shape[0] != T for leaf in leaves):
        raise ValueError("inputs must share T")
    local = [_chunk(leaf, group) for leaf in leaves]
    Tl = local[0].shape[0]
    if halo:
        local = [torch.cat([_gather_left(leaf, halo, group), leaf]) for leaf in local]
    out = apply_fn(tree_unflatten(local, spec))
    t = out.shape[time_axis]
    return all_gather(out.narrow(time_axis, t - Tl, Tl), group, dim=time_axis)
