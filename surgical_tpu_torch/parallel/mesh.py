"""Process groups and the data-parallel helpers on ``torch.distributed``.

Port of ``surgical_tpu/parallel/mesh.py``. JAX lays a 1-D ``data`` mesh
over the chips of one process and places arrays on it: the batch sharded
along its leading axis (``P("data")``), parameters replicated. Here every
rank is a process with one device, and ``group`` names the ranks that
share the work (``None``: the default group). Where no default group was
initialised (``WORLD_SIZE`` unset or 1) every helper is the identity, so
the same code runs on one device.

Collectives. NCCL takes CUDA tensors and keeps everything on the device.
gloo takes CPU tensors and, in the torch build on the H100 machine (2.11),
CUDA tensors in every collective used here (``COLLECTIVES``: it copies them
through host memory itself), so ranks that share one card run over gloo
with their tensors on the card; ``chip_smoke.py`` phase 15 probes each
collective on the card (``probe_collectives``) and fails on a build whose
gloo refuses one. ``all_reduce_autograd`` carries the gradient through a
sum: its backward sums the output gradients over the group, which is what
a statistic computed over the whole group's batch (train-mode BatchNorm)
needs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves, tree_map

from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

# the collectives of this module, each of which gloo must take on CUDA tensors
# for ranks that share a card (probe_collectives)
COLLECTIVES = ("all_reduce", "broadcast", "all_gather")


def init_from_env(device=DEFAULT_DEVICE, backend: str | None = None
                  ) -> tuple[int, int, torch.device]:
    """Join the default process group that ``torch.distributed.run`` (or
    ``torchrun``) describes in ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``; returns (rank, world size, this
    rank's device). ``WORLD_SIZE`` unset or 1 starts no group: (0, 1,
    device).

    ``device`` goes through ``resolve_device``: ``cuda`` is this rank's card
    (``cuda:LOCAL_RANK``), an explicit ``cuda:i`` is taken as given (ranks
    sharing one card), ``cpu`` is the CPU. ``backend``: ``nccl`` or
    ``gloo``; None takes NCCL on a CUDA device and gloo on the CPU. A
    backend that fails to initialise raises: nothing switches backends."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(device)
    if world <= 1:
        return 0, 1, device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl|gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend takes CUDA devices, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return rank, world, device


def rank_world(group=None) -> tuple[int, int]:
    """(this rank within ``group``, the group's size); (0, 1) without a
    default group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_batch(batch, target: int):
    """Zero-pad every array or tensor of ``batch`` (any pytree; ``None``
    stays) along its leading axis to ``target`` frames; returns (padded,
    validity mask [target] bool). The last extraction batch is padded so
    that it divides evenly over the ranks and runs the route of the full
    batches."""
    n = next(a for a in tree_leaves(batch) if a is not None).shape[0]
    mask = np.zeros((target,), dtype=bool)
    mask[:n] = True
    if n == target:
        return batch, mask

    def pad(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a.new_zeros((target - n, *a.shape[1:]))])
        return np.pad(np.asarray(a), [(0, target - n)] + [(0, 0)] * (np.ndim(a) - 1))

    return tree_map(pad, batch), mask


def shard_range(n: int, group=None) -> slice:
    """This rank's contiguous slice of a leading axis of ``n``, as
    ``P("data")`` lays it out: rank r holds [r n/w, (r+1) n/w). Raises
    unless the group's size divides ``n`` (JAX's sharded ``device_put``
    fails there too)."""
    rank, world = rank_world(group)
    if n % world:
        raise ValueError(f"a leading axis of {n} does not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, group=None):
    """This rank's slice (``shard_range``) of every array or tensor of
    ``batch`` (any pytree; ``None`` stays)."""
    n = next(a for a in tree_leaves(batch) if a is not None).shape[0]
    sl = shard_range(n, group)
    return tree_map(lambda a: None if a is None else a[sl], batch)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor on ``x``'s device
    (``x`` itself without a group)."""
    if rank_world(group)[1] == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    rank order, on ``x``'s device."""
    world = rank_world(group)[1]
    if world == 1:
        return x
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group, rank) if group is not None else rank


def broadcast_(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``x`` in place with rank ``src``'s (a rank of ``group``)."""
    if rank_world(group)[1] > 1:
        dist.broadcast(x, _global(group, src), group=group)
    return x


def replicate(module: torch.nn.Module, group=None, src: int = 0) -> torch.nn.Module:
    """Give every rank rank ``src``'s parameters and buffers (in place), the
    counterpart of placing a parameter tree replicated (``P()``)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src, group)
    return module


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        # every rank's output is the same sum of every rank's input, so an
        # input's gradient is the sum of the output gradients over the group
        return all_reduce(grad.contiguous(), ctx.group), None


def all_reduce_autograd(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce`` that autograd differentiates: every rank must run the
    backward (a plain ``dist.all_reduce`` inside a forward cuts the
    gradient without an error)."""
    if rank_world(group)[1] == 1:
        return x
    return _AllReduceSum.apply(x, group)


def probe_collectives(device, group=None) -> dict:
    """{collective: None if the group's backend ran it right on a tensor of
    ``device``, else the error's text} for each of ``COLLECTIVES``; every
    rank of the group must call it."""
    rank, world = rank_world(group)
    out = {}
    for op in COLLECTIVES:
        x = torch.full((4,), float(rank + 1), device=device)
        try:
            if op == "all_reduce":
                dist.all_reduce(x, group=group)
                ok = bool((x == world * (world + 1) / 2).all())
            elif op == "broadcast":
                dist.broadcast(x, _global(group, 0), group=group)
                ok = bool((x == 1).all())
            else:
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x, group=group)
                ok = all(bool((p == i + 1).all()) for i, p in enumerate(parts))
            out[op] = None if ok else "wrong values"
        except (RuntimeError, ValueError) as e:
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        # a refused collective must leave every rank in step before the next
        nccl = dist.get_backend(group) == "nccl"
        dist.barrier(group=group, device_ids=[device.index] if nccl else None)
    return out
