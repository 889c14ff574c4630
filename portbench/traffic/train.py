"""Backbone fine-tuning (``train-backbone``): the prompted backbone's
trainable parts (head, prompt generator, flow encoder, the two flow
cross-attentions) on a frozen trunk.

One ``BackboneTrainer`` (the flax graph, ``use_fused`` as the workload
says, SGD at the CLI's default lr, no clipping) steps through wire batches
of ``batch`` frames at ``resize`` px (cropped to ``crop`` on the device)
from a seeded pool of host batches that is cycled, each step's loss read
back as the trainer's own loop reads it. Augmentation parameters and the
DropPath / head-dropout masks are drawn by the benchmark from the seed, one
set per pool batch, and handed to ``train_step`` so that the reference can
follow the same steps.

Set-up builds the trainer, drives it through its first ``checked_steps``
steps on distinct batches through the window's own call, and records
each step's loss, the first gradient as the optimizer holds it (the
momentum buffer after one step) and, after the last, each trainable
leaf's change and the BatchNorm statistics; the window continues the same
object. The check repeats those steps in the fp32 reference and compares
each step's loss, and per trainable leaf the norms of the first gradient
and of the change, by the worst leaf and by the median leaf's gap (the
worst leaf is as a rule one of the earliest prompt leaves, whose gradient
comes back through the whole trunk at bf16), and the BatchNorm
statistics' change.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import compare, files, program, weights
from harness.trace import span
from reference import mit, work

TRAINABLE = ("head", "prompt_generator", "flow_encoder", "cross_attn_s3", "cross_attn_s4")
# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone (a bias in front of a BatchNorm): not compared
NOUGHT = 1e-3


def trainable(key: str) -> bool:
    return key.split(".")[0] in TRAINABLE


def is_bn_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def draw_feed(seed, n, cfg, head_cfg, p, device):
    """``n`` host wire batches with labels and anticipation targets, and
    per batch the augmentation parameters and masks, from the seed."""
    g = weights.generator(seed, "train-feed", device)
    B, R, C = p["batch"], p["resize"], p["crop"]
    rates = np.linspace(0, cfg["drop_path_rate"], sum(cfg["depths"]))
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=g, device=device)
    deg = p["degrees"]
    feed = []
    for _ in range(n):
        wire = (torch.randint(0, 256, (B, R, R, 3), generator=g, device=device, dtype=torch.uint8),
                torch.randint(0, 256, (B, R, R, 1), generator=g, device=device, dtype=torch.uint8),
                (torch.randn(B, R, R, 2, generator=g, device=device) * p["flow_std"]).half(),
                torch.randint(0, head_cfg["num_phases"], (B,), generator=g, device=device),
                torch.rand(B, head_cfg["num_phases"], generator=g, device=device) * p["horizon"])
        aug = (torch.randint(0, R - C + 1, (B, 2), generator=g, device=device),
               torch.rand(B, generator=g, device=device) < 0.5,
               torch.randint(-deg, deg + 1, (B,), generator=g, device=device).float(),
               u(0.9, 1.1), u(0.9, 1.1), u(0.9, 1.1), u(-0.05, 0.05))
        dp = []
        for r in rates:
            keep = 1.0 - float(r)
            dp.append(tuple((torch.rand(B, generator=g, device=device) < keep).float() / keep
                            for _ in range(2)))
        drop = torch.rand(B, head_cfg["embedding_dim"], generator=g, device=device) \
            >= head_cfg["dropout"]
        feed.append({"wire": tuple(t.cpu().numpy() for t in wire), "aug": aug,
                     "masks": {"droppath": dp, "dropout": drop}})
    return feed


def train_flops(config, sd, crop) -> int:
    """The reference step's FLOPs for one frame (forward and the backward
    to the trainable leaves), counted on meta tensors."""
    cfg, head = config["backbone"]["config"], config["backbone"]["head"]
    meta = {k: torch.empty_like(v, device="meta").requires_grad_(
        trainable(k) and v.is_floating_point() and not is_bn_stat(k)) for k, v in sd.items()}
    x = lambda c: torch.empty(1, crop, crop, c, device="meta")
    one = torch.ones(1, device="meta")
    masks = {"droppath": [(one, one)] * sum(cfg["depths"]),
             "dropout": torch.ones(1, head["embedding_dim"], dtype=torch.bool, device="meta")}

    def step():
        (y, ya), _ = mit.forward(meta, cfg, head, x(3), x(3), x(2), mlp_gelu="erf", train=True,
                                 masks=masks, return_features=False)
        loss = mit.backbone_loss(y, ya, torch.zeros(1, dtype=torch.long, device="meta"),
                                 torch.empty(1, head["num_phases"], device="meta"))
        loss.backward()

    return work.count_flops(step)


def setup(ctx):
    p, dev, conf = ctx.params, ctx.device, ctx.config
    cfg, head = conf["backbone"]["config"], conf["backbone"]["head"]
    with ctx.phase("weights"):
        model, sd = program.backbone(conf, ctx.seed, dev)
    TrainConfig = files.resolve("surgical_tpu_torch.core.config:TrainConfig")
    OptimConfig = files.resolve("surgical_tpu_torch.core.config:OptimConfig")
    AugConfig = files.resolve("surgical_tpu_torch.data.transforms:AugConfig")
    Trainer = files.resolve("surgical_tpu_torch.train.backbone:BackboneTrainer")
    AugParams = files.resolve("surgical_tpu_torch.data.transforms:AugParams")
    trainer = Trainer(model, TrainConfig(optim=OptimConfig(
        name=p["optimizer"], lr=p["lr"], weight_decay=0.0, grad_clip_norm=None)),
        AugConfig(resize=p["resize"], crop=p["crop"], degrees=float(p["degrees"])),
        use_fused=p["use_fused"])
    trainer.init()
    with ctx.phase("frames"):
        feed = draw_feed(ctx.seed, p["pool_batches"], cfg, head, p, dev)
    with ctx.phase("flop count"):
        flops = train_flops(conf, sd, p["crop"])
    st = SimpleNamespace(ctx=ctx, model=model, trainer=trainer, sd=sd, feed=feed,
                         AugParams=AugParams, flops=flops)
    params = {k for k, v in model.named_parameters() if v.requires_grad}
    st.leaves = sorted(params)
    st.bn_keys = sorted(k for k in sd if trainable(k) and is_bn_stat(k))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()
              if k in params or k in st.bn_keys}
    st.losses = []
    for s in range(p["checked_steps"]):
        with ctx.phase(f"step {s + 1}"):
            st.losses.append(step(st, s))
        if s == 0:
            opt = trainer.optimizer
            named = dict(model.named_parameters())
            st.first_grad = {k: opt.state[named[k]]["momentum_buffer"].norm()
                             if "momentum_buffer" in opt.state.get(named[k], {})
                             else torch.zeros((), device=dev) for k in st.leaves}
    now = model.state_dict()
    st.change = {k: (now[k].float() - before[k].float()).norm() for k in before}
    st.first_grad = {k: float(v) for k, v in st.first_grad.items()}
    st.change = {k: float(v) for k, v in st.change.items()}
    return st


def step(st, s):
    """One optimizer step on pool batch s (cycled), its loss read back."""
    item = st.feed[s % len(st.feed)]
    img, seg, flow, labels, ant = item["wire"]
    out = st.trainer.train_step(img, seg, flow, labels, ant, epoch=0, step=s,
                                aug_params=st.AugParams(*item["aug"]), masks=item["masks"])
    return float(out["loss"])


def unit(st, i):
    t = time.perf_counter()
    with span("train_step"):
        loss = step(st, st.ctx.params["checked_steps"] + i)
    return {"n": st.ctx.params["batch"], "ms": (time.perf_counter() - t) * 1e3, "loss": loss}


def end_to_end(st, records, window_s):
    return {"train_fps": sum(r["n"] for r in records) / window_s}


def counts(st, records):
    return {"frames": sum(r["n"] for r in records), "steps": len(records)}


def least_s(st, records):
    dtype = st.ctx.config["dtype"]["backbone"]
    return sum(r["n"] for r in records) * st.flops / work.PEAK_FLOPS[dtype]


def release(st):
    st.model = st.trainer = None


def reference_steps(st, quant=None):
    """The first ``checked_steps`` steps in the reference: (losses, first
    gradient's leaf norms, leaf changes, BatchNorm statistics' changes)."""
    p, conf = st.ctx.params, st.ctx.config
    cfg, head = conf["backbone"]["config"], conf["backbone"]["head"]
    dev = st.ctx.device
    state = {k: v.detach().clone() for k, v in st.sd.items()}
    leaves = st.leaves
    for k in leaves:
        state[k].requires_grad_(True)
    mom, losses, first = {}, [], {}
    with compare.precision(False):
        for s in range(p["checked_steps"]):
            item = st.feed[s % len(st.feed)]
            img_u8, seg_u8, flow, labels, ant = (torch.from_numpy(a).to(dev) for a in item["wire"])
            img, seg, fl = mit.augment(img_u8, seg_u8, flow, item["aug"], p["crop"], p["degrees"])
            (y, ya), stats = mit.forward(state, cfg, head, img, seg, fl, mlp_gelu="erf",
                                         train=True, masks=item["masks"], quant=quant,
                                         return_features=False)
            loss = mit.backbone_loss(y, ya, labels.long(), ant.float())
            grads = torch.autograd.grad(loss, [state[k] for k in leaves])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    mom[k] = g.clone() if s == 0 else 0.9 * mom[k] + g
                    state[k] -= p["lr"] * mom[k]
                if s == 0:
                    first = {k: float(mom[k].norm()) for k in leaves}
                for k, v in stats.items():
                    state[k].copy_(v)
    change = {k: float((state[k].detach() - st.sd[k]).norm()) for k in leaves + st.bn_keys}
    return losses, first, change


def check(st, records, ctx):
    limits = ctx.workload["limits"]
    ref = reference_steps(st)
    if ctx.control:
        got = reference_steps(st, quant=compare.fp8)
    else:
        got = (st.losses, st.first_grad, st.change)
    med = float(np.median([ref[1][k] for k in st.leaves]))
    moved = [k for k in st.leaves if ref[1][k] >= NOUGHT * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
    grad = compare.norm_gaps(got[1], ref[1], moved)
    change = compare.norm_gaps(got[2], ref[2], moved)
    numbers = {"loss_gap": loss_gap,
               "first_grad_gap": float(grad.max()), "first_grad_median_gap": float(grad.median()),
               "change_gap": float(change.max()), "change_median_gap": float(change.median()),
               "bn_change_gap": compare.norm_gap(got[2], ref[2], st.bn_keys)}
    return [(n, v, limits[n]) for n, v in numbers.items()]
