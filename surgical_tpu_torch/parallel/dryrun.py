"""Multi-rank dry run and the batch-sharded backbone step.

Port of ``__graft_entry__.dryrun_multichip``: the backbone train step over a
batch sharded on the data axis (parameters replicated, BatchNorm statistics
and the loss over the whole batch), the time-sharded MS-TCN and Mamba
against the one-rank models, and data-parallel extraction against one rank.

- ``spawn`` runs a function on n ranks, each a process started by
  ``torch.multiprocessing`` that joins a group through a ``file://``
  rendezvous in a temporary directory (no port to collide with another
  run), and returns each rank's result. ``device="cuda"`` (the default)
  puts rank r on ``cuda:r`` (NCCL by default); ``cuda:i`` puts every rank
  on card i, which NCCL refuses, so the group is gloo; ``cpu`` runs gloo on
  the CPU with one torch thread per rank.
- ``data_parallel_step`` is ``BackboneTrainer.train_step`` over a batch
  sharded on the group.
- The ``*_leg`` functions run inside a rank: each rank computes its share,
  and rank 0 also computes the one-rank reference and the distances.
- ``dryrun_multirank`` runs every leg at the dry run's dims
  (``__graft_entry__.py:125-133``) and returns a report; it raises where a
  leg misses its bound.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from surgical_tpu_torch.core.device import DEFAULT_DEVICE
from surgical_tpu_torch.parallel import mesh

TIMEOUT_S = 600.0  # a rank waits this long for its peers in a collective
# bounds of the dry run (JAX's __graft_entry__.py:182-184, :202-204)
MSTCN_BOUND = 1e-5
MAMBA_BOUND = 2e-4
STEP_BOUND = 1e-6  # rel L2, fp32, n-rank step against the one-rank step


def _rank_main(rank, world, fn, args, device, backend, init_file, out_dir):
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(dev, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device: str = DEFAULT_DEVICE,
          backend: str | None = None) -> list:
    """Run ``fn(device, *args)`` on ``world`` ranks in fresh processes (a
    module-level function and picklable arguments); returns the ranks'
    results in rank order. A rank that raises makes this raise (the other
    ranks are stopped)."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, fn, args, device, backend, os.path.join(tmp, "rendezvous"), tmp))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def run_legs(device, legs) -> list:
    """Inside a rank: each (leg function, keyword arguments) in turn; their
    results in order."""
    return [leg(device, **kw) for leg, kw in legs]


# -- the batch-sharded backbone step --------------------------------------------

def data_parallel_step(trainer, img_u8, seg_u8, flow_f16, labels, ant, epoch: int = 0,
                       step: int = 0, group=None) -> dict:
    """One optimizer step of ``trainer`` (a ``BackboneTrainer``) over the
    global batch sharded on ``group`` (None: the default group), the
    counterpart of JAX's ``make_backbone_train_step`` jitted over a batch
    placed with ``P("data")``. Every rank passes the whole wire batch and
    keeps its contiguous B / world frames (B must divide).

    The augmentation parameters and the DropPath / dropout masks are drawn
    for the whole batch from the step's generators (those the one-rank step
    draws from), and each rank takes its slice, so the n-rank step computes
    the one-rank step's function. BatchNorm takes its statistics over the
    group through an all-reduce that autograd differentiates. The loss is a
    sum over frames (``train/losses.py``), so the trainable gradients are
    summed over the group (not averaged, as DDP does) before the update; the
    returned loss, ce, reg and correct are the group's sums."""
    from surgical_tpu_torch.data.transforms import AugParams, draw_params
    from surgical_tpu_torch.models.mit_train import draw_masks, write_bn_stats

    model = trainer.model
    cfg, head_cfg = model.cfg, model.head_cfg
    if not trainer.use_fused and cfg.drop_rate > 0.0:
        raise NotImplementedError("data_parallel_step draws DropPath and head dropout for the "
                                  "global batch; block dropout (drop_rate > 0) is not drawn")
    _, world = mesh.rank_world(group)
    B = len(labels)
    sl = mesh.shard_range(B, group)
    aug = draw_params(trainer._generator(epoch, step, "augment"), trainer.aug_cfg, B)
    masks = draw_masks(cfg, head_cfg, B, trainer._generator(epoch, step, "droppath"))
    local_aug = AugParams(*(t[sl] for t in aug))
    local_masks = {"droppath": [(m1[sl], m2[sl]) for m1, m2 in masks["droppath"]],
                   "dropout": None if masks["dropout"] is None else masks["dropout"][sl]}
    bn_group = None if world == 1 else (group if group is not None else dist.group.WORLD)
    batch = mesh.shard_batch((img_u8, seg_u8, flow_f16, labels, ant), group)
    out, stats = trainer.loss_and_grad(*batch, epoch, step, aug_params=local_aug,
                                       masks=local_masks, bn_group=bn_group)
    if world > 1:
        params = [p for p in model.parameters() if p.grad is not None]
        flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))
    trainer.optimizer.step()
    write_bn_stats(model, stats)
    keys = ("loss", "ce", "reg", "correct")
    sums = mesh.all_reduce(torch.stack([out[k].float() for k in keys]), group)
    return dict(zip(keys, sums.unbind()))


# -- legs (run inside a rank) ---------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fp32_exact() -> None:
    """fp32 references on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _subgroup(size):
    """This rank's group of ``size`` consecutive ranks (None: the default
    group); every rank must call it."""
    return None if size is None else dist.new_subgroups(size)[0]


def _rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def temporal_leg(device, kind: str, cfg, T: int, seed: int = 0, state_dict=None, x=None,
                 scale: float = 1.0, group_size=None) -> dict:
    """``sp_mstcn_infer`` (``kind="mstcn"``) or ``sp_mamba_infer``
    (``"mamba"``) of a [T, f_dim] video (``x``, else seeded normal x
    ``scale``) over the group of ``group_size`` ranks (None: all), the
    model's weights from ``state_dict`` or its seeded init. Every rank:
    seconds and selective-scan launches of its share; rank 0 also "out" (the
    sharded output), "ref" (the one-rank model on the same device) and
    "max_abs"."""
    from surgical_tpu_torch.kernels import selective_scan as scan_kernel
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.parallel.sequence import sp_mamba_infer, sp_mstcn_infer

    _fp32_exact()
    group = _subgroup(group_size)
    cls, sp = {"mstcn": (MultiStageTCN, sp_mstcn_infer),
               "mamba": (CausalMambaModel, sp_mamba_infer)}[kind]
    model = cls(cfg, seed=seed, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    mesh.replicate(model, group)
    if x is None:
        x = np.random.default_rng(seed).standard_normal((T, cfg.f_dim)).astype(np.float32) * scale
    xt = torch.as_tensor(x).to(device)
    scan_kernel.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    out = sp(model, xt, group)
    _sync(device)
    res = {"seconds": time.perf_counter() - t0,
           "scan_launches": scan_kernel.selective_scan.launches, "ranks": mesh.rank_world(group)[1]}
    if dist.get_rank() == 0:
        with torch.no_grad():
            ref = model(xt[None])
        ref = ref[:, 0] if kind == "mstcn" else ref[0, 0]
        res.update(out=out.cpu().numpy(), ref=ref.cpu().numpy(),
                   max_abs=float((out - ref).abs().max()))
    return res


def seq_infer_leg(device, a, b, halo: int) -> dict:
    """``sequence_parallel_infer`` of a bounded causal window mean over the
    tuple (a, b) [T, D] (the JAX test's function); rank 0 returns "out" and
    "ref" (the function on the whole inputs)."""
    from surgical_tpu_torch.parallel.sequence import sequence_parallel_infer

    def causal_fn(inp):
        x, y = inp
        s = x + 2.0 * y
        w = torch.stack([torch.nn.functional.pad(s, (0, 0, k, 0))[:s.shape[0]]
                         for k in range(halo + 1)])
        return w.mean(0)[None]

    a, b = torch.as_tensor(a).to(device), torch.as_tensor(b).to(device)
    out = sequence_parallel_infer(causal_fn, (a, b), halo)
    if dist.get_rank() != 0:
        return {}
    return {"out": out.cpu().numpy(), "ref": causal_fn((a, b)).cpu().numpy()}


def wire_frames(n: int, size: int, with_flow: bool, seed: int):
    """n seeded wire-format frames: uint8 [n, size, size, 3] and [n, size,
    size, 1], f16 flow [n, size, size, 2] or None."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8)
    flow = (rng.standard_normal((n, size, size, 2)) * 2).astype(np.float16) if with_flow else None
    return img, seg, flow


def extract_leg(device, cfg, head_cfg, frames: int, batch: int, size: int, seed: int = 0,
                use_fused=None, weight_quant=None) -> dict:
    """Data-parallel extraction of ``frames`` seeded wire frames in batches
    of ``batch`` (a ragged last batch padded, as ``extract_features`` pads
    it) through ``make_raw_feature_fn`` over all ranks. Every rank: its
    kernel launches and seconds, whether a batch that does not divide over
    the ranks raised, and the rows that ``make_raw_feature_fn`` without a
    group returned for that batch (all of them: no group is this process
    alone, whatever group is initialised); rank 0 also "equal" (bit for
    bit) and "max_abs" against that function at batch / world, i.e. on each
    rank's shard; ``use_fused`` and ``weight_quant`` go to both."""
    from surgical_tpu_torch.kernels import mit_block
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn

    rank, world = mesh.rank_world()
    model = MiTEVP(cfg, head_cfg, seed=seed, device=device)
    mesh.replicate(model)
    img, seg, flow = wire_frames(frames, size, cfg.with_flow, seed + 1)
    batches = lambda b: [(img[i:i + b], seg[i:i + b], None if flow is None else flow[i:i + b])
                         for i in range(0, frames, b)]
    E = head_cfg.embedding_dim
    fn = make_raw_feature_fn(model, use_fused=use_fused, weight_quant=weight_quant,
                             group=dist.group.WORLD)
    mit_block.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    feats, _ = extract_features(fn, batches(batch), frames, E, batch)
    _sync(device)
    res = {"seconds": time.perf_counter() - t0, "launches": mit_block.launch_counts(),
           "batches": len(batches(batch)), "rank_batch": batch // world}
    odd = batch + 1 if (batch + 1) % world else batch + 2
    odd_frames = wire_frames(odd, size, cfg.with_flow, seed + 2)
    try:
        fn(*odd_frames)
        res["odd_batch_raised"] = False
    except ValueError:
        res["odd_batch_raised"] = True
    single = make_raw_feature_fn(model, use_fused=use_fused, weight_quant=weight_quant)
    res.update(odd=odd, alone_rows=int(single(*odd_frames).shape[0]))
    if rank == 0:
        want, _ = extract_features(single, batches(batch // world), frames, E, batch // world)
        res.update(equal=bool(np.array_equal(feats, want)),
                   max_abs=float(np.abs(feats - want).max()), shape=feats.shape)
    return res


def _state_hash(model) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def step_leg(device, cfg, head_cfg, batch: int, resize: int, crop: int, dtype=torch.float32,
             use_fused: bool = False, seed: int = 0, lr: float = 1e-2) -> dict:
    """One ``data_parallel_step`` of a seeded ``BackboneTrainer`` (SGD at
    ``lr``, compute ``dtype``, the fused train kernels with ``use_fused``)
    on ``batch`` seeded wire frames at ``resize`` px cropped to ``crop``,
    over all ranks. Every rank: its kernel launches, seconds and a hash of
    its state after the step; rank 0 also the one-rank step on the whole
    batch from the same state (the same generators, so the same draws):
    loss, ce and reg of both, and the rel L2 distance of the trainable
    gradients, the BatchNorm running statistics and the parameters after
    the step."""
    from surgical_tpu_torch.core.config import OptimConfig, TrainConfig
    from surgical_tpu_torch.data.transforms import AugConfig
    from surgical_tpu_torch.kernels import mit_block
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.train.backbone import BackboneTrainer

    _fp32_exact()
    train_cfg = TrainConfig(optim=OptimConfig(name="sgd", lr=lr))
    aug_cfg = AugConfig(resize=resize, crop=crop)

    def trainer():
        t = BackboneTrainer(MiTEVP(cfg, head_cfg, seed=seed, device=device), train_cfg, aug_cfg,
                            use_fused=use_fused, compute_dtype=dtype)
        t.init()
        return t

    tr = trainer()
    mesh.replicate(tr.model)
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}
    img, seg, flow = wire_frames(batch, resize, cfg.with_flow, seed + 3)
    rng = np.random.default_rng(seed + 4)
    labels = rng.integers(0, 7, batch).astype(np.int32)
    ant = rng.uniform(0, 5, (batch, 7)).astype(np.float32)
    mit_block.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    got = data_parallel_step(tr, img, seg, flow, labels, ant)
    _sync(device)
    res = {"seconds": time.perf_counter() - t0, "launches": mit_block.launch_counts(),
           "hash": _state_hash(tr.model), "loss": float(got["loss"])}
    if dist.get_rank() != 0:
        return res
    ref = trainer()
    ref.model.load_state_dict(start)
    want = ref.train_step(img, seg, flow, labels, ant)
    names = [n for n, p in tr.model.named_parameters() if p.grad is not None]
    cat = lambda m, f: torch.cat([f(m, n).reshape(-1).double() for n in names])
    grad = lambda m, n: m.get_parameter(n).grad
    bn = lambda m: torch.cat([b.reshape(-1).double() for n, b in m.named_buffers()
                              if "running" in n])
    params = lambda m: torch.cat([p.detach().reshape(-1).double() for p in m.parameters()])
    res.update({
        "ref_loss": float(want["loss"]),
        "loss_rel": abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"])),
        **{k: (float(got[k]), float(want[k])) for k in ("ce", "reg", "correct")},
        "grad_rel_l2": _rel_l2(cat(tr.model, grad), cat(ref.model, grad)),
        "bn_rel_l2": _rel_l2(bn(tr.model), bn(ref.model)),
        "param_rel_l2": _rel_l2(params(tr.model), params(ref.model)),
        "bn_moved": _rel_l2(bn(tr.model), torch.cat([v.reshape(-1).double() for k, v in
                                                     start.items() if "running" in k])),
        "grads": len(names)})
    return res


def probe_leg(device) -> dict:
    """Which collectives the group's backend runs on this device's tensors
    (``mesh.probe_collectives``)."""
    return mesh.probe_collectives(device)


# -- the dry run ------------------------------------------------------------------

DRYRUN_BACKBONE = dict(variant="dryrun", embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 4, 8),
                       depths=(1, 1, 1, 1), sr_ratios=(8, 4, 2, 1), qkv_bias=True,
                       drop_path_rate=0.1)
DRYRUN_SIZE = 64


def dryrun_legs(n: int, device: str) -> list:
    """The dry run's legs at its dims: the batch-sharded step (B = 2n frames
    at 64 px), MS-TCN (2 x 4 layers, f_maps 8, f_dim 32) and Mamba (1 layer,
    d_model 16, f_dim 32, d_state 8, as the JAX package's dry run) over
    T = 32n, and extraction of 5n frames in batches of 2n (a ragged tail)."""
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MambaConfig,
                                                MSTCNConfig)

    cfg = BackboneConfig(**DRYRUN_BACKBONE)
    head = HeadConfig(embedding_dim=64, hidden=32)
    T = 32 * n
    return [
        (step_leg, dict(cfg=cfg, head_cfg=head, batch=2 * n, resize=DRYRUN_SIZE + 8,
                        crop=DRYRUN_SIZE)),
        (temporal_leg, dict(kind="mstcn", cfg=MSTCNConfig(stages=2, layers=4, f_maps=8,
                                                          f_dim=32), T=T, seed=2)),
        (temporal_leg, dict(kind="mamba", cfg=MambaConfig(layers=1, d_model=16, f_dim=32,
                                                          d_state=8, out_features=7,
                                                          dropout=0.0),
                            T=T, seed=3, scale=0.1)),
        # the serving kernels take head widths 32 and 64, and the dry run's are
        # 16 / 16 / 10 / 8: on the card it extracts on the flax graph, on the
        # CPU on the serving graph
        (extract_leg, dict(cfg=cfg, head_cfg=head, frames=5 * n, batch=2 * n,
                           size=DRYRUN_SIZE, use_fused=None if device == "cpu" else False)),
    ]


def dryrun_multirank(n: int, device: str = DEFAULT_DEVICE, backend: str | None = None) -> dict:
    """The multi-rank dry run on ``n`` ranks (``spawn``'s ``device`` and
    ``backend``): every leg of ``dryrun_legs`` in one spawn, each held to its
    bound against the one-rank computation; returns the report, raises
    ``AssertionError`` on a miss."""
    t0 = time.perf_counter()
    ranks = spawn(run_legs, n, dryrun_legs(n, device), device=device, backend=backend)
    step, mstcn, mamba, ext = ranks[0]
    report = {
        "ranks": n, "device": device, "seconds": time.perf_counter() - t0,
        "step": {k: step[k] for k in ("loss", "ref_loss", "loss_rel", "grad_rel_l2",
                                      "bn_rel_l2", "param_rel_l2")},
        "step_states_equal": len({r[0]["hash"] for r in ranks}) == 1,
        "mstcn_max_abs": mstcn["max_abs"], "mamba_max_abs": mamba["max_abs"],
        "extract_equal": ext["equal"],
        "extract_odd_batch_raised": all(r[3]["odd_batch_raised"] for r in ranks),
        "extract_alone_whole": all(r[3]["alone_rows"] == r[3]["odd"] for r in ranks),
    }
    misses = [k for k, ok in (
        ("step", max(step["loss_rel"], step["grad_rel_l2"], step["bn_rel_l2"],
                     step["param_rel_l2"]) <= STEP_BOUND),
        ("step_states_equal", report["step_states_equal"]),
        ("mstcn", mstcn["max_abs"] <= MSTCN_BOUND), ("mamba", mamba["max_abs"] <= MAMBA_BOUND),
        ("extract", ext["equal"]), ("odd batch", report["extract_odd_batch_raised"]),
        ("extract alone", report["extract_alone_whole"]))
        if not ok]
    if misses:
        raise AssertionError(f"dryrun_multirank({n}) missed {misses}: {report}")
    return report
