"""Optical-flow bank rebuild (``precompute-flow``): RAFT over the 1-fps
frame pairs of a corpus, the flows back on the host for the driver to write.

A closed loop of calls of the batched flow function ``make_flow_fn`` (the
one ``FlowPrecomputeDriver`` calls), each over ``batch`` pairs (n, n + 1)
of ``batch`` + 1 consecutive uint8 frames of ``size`` px held in pageable
host memory: the frames go to the card as they are, are mapped and
edge-padded to a multiple of 8 there, and RAFT runs ``iters`` refinement
steps in fp32 with TF32 off; the flows come back as float32 numpy. A clip
is a smooth texture drawn from the seed (coarse noise upsampled 8x) seen
through a window that moves by a seeded 0 to ``max_shift`` px in x and in y
from each frame to the next, so that consecutive frames correlate as a
moving laparoscope's do; a seeded pool of ``pool_batches`` distinct clips
is cycled.

The check draws ``check_batches`` of the window's batches from the seed and
holds every pixel of every pair to the fp32 reference's flow, computed one
pair at a time (``flow_gap``, the L2 norm over (u, v)).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from harness import compare, files, program, weights
from harness.trace import span
from reference import raft as ref
from reference import work


def clip_pool(seed, n, frames, size, max_shift, device):
    """``n`` host clips, each uint8 [frames, size, size, 3]: a smooth
    texture through a window moving by a seeded 0..max_shift px per frame."""
    g = weights.generator(seed, "flow-frames", device)
    side = size + max_shift * (frames - 1)
    pool = []
    for _ in range(n):
        coarse = torch.rand(1, 3, side // 8 + 2, side // 8 + 2, generator=g, device=device) * 255
        canvas = F.interpolate(coarse, scale_factor=8, mode="bilinear")[0]
        canvas = canvas.clamp(0, 255).round().to(torch.uint8).permute(1, 2, 0)
        steps = torch.randint(0, max_shift + 1, (frames - 1, 2), generator=g, device=device)
        at = torch.cat([steps.new_zeros(1, 2), steps.cumsum(0)]).tolist()
        clip = torch.stack([canvas[y:y + size, x:x + size] for x, y in at])
        pool.append(clip.cpu().numpy())
    return pool


def model_args(config, iters):
    r = config["raft"]
    return iters, r["corr_levels"], r["corr_radius"]


def pair_flops(config, sd, size, iters) -> int:
    """The reference's FLOPs for one pair at the padded size, counted on
    meta tensors at one and two iterations (every iteration does the same
    work)."""
    meta = {k: torch.empty_like(v, device="meta") for k, v in sd.items()}
    S = size + (-size) % 8
    x = torch.empty(1, 3, S, S, device="meta")
    _, levels, radius = model_args(config, iters)
    one, two = (work.count_flops(ref.raft, meta, x, x, n, levels, radius) for n in (1, 2))
    return one + (iters - 1) * (two - one)


def setup(ctx):
    p, dev, conf = ctx.params, ctx.device, ctx.config
    spec = conf["raft"]
    with ctx.phase("weights"):
        model, sd = weights.build(files.resolve(spec["constructor"]),
                                  model_args(conf, p["iters"]), ctx.seed, "raft", dev)
    widths = (model.fnet.conv2.out_channels, model.cnet.conv2.out_channels, model.hidden)
    if widths != (spec["fnet_dim"], spec["cnet_dim"], spec["hidden_dim"]):
        raise ValueError(f"the program's RAFT has widths {widths}, the configuration {spec}")
    fn = files.resolve("surgical_tpu_torch.models.raft:make_flow_fn")(model)
    B, S = p["batch"], p["size"]
    with ctx.phase("frames"):
        pool = clip_pool(ctx.seed, p["pool_batches"], B + 1, S, p["max_shift"], dev)
    with ctx.phase("warm-up"):
        for clip in pool[:2]:
            fn(clip[:-1], clip[1:])
    with ctx.phase("flop count"):
        flops = pair_flops(conf, sd, S, p["iters"])
    return SimpleNamespace(ctx=ctx, model=model, fn=fn, sd=sd, pool=pool, flops=flops)


def unit(st, i):
    k = i % len(st.pool)
    clip = st.pool[k]
    t = time.perf_counter()
    with span("flow_batch"):
        flows = st.fn(clip[:-1], clip[1:])
    return {"n": len(clip) - 1, "ms": (time.perf_counter() - t) * 1e3, "flows": flows, "pool": k}


def end_to_end(st, records, window_s):
    return {"extract_fps": sum(r["n"] for r in records) / window_s}


def counts(st, records):
    n = sum(r["n"] for r in records)
    return {"frames": n, "pairs": n, "batches": len(records)}


def least_s(st, records):
    dtype = st.ctx.config["dtype"]["raft"]
    return sum(r["n"] for r in records) * st.flops / work.PEAK_FLOPS[dtype]


def release(st):
    st.model = st.fn = None


def reference_flows(st, picks, tf32=False):
    p, dev = st.ctx.params, st.ctx.device
    _, levels, radius = model_args(st.ctx.config, p["iters"])
    out = []
    for k in picks:
        clip = torch.from_numpy(st.pool[k]).to(dev)
        out.append(ref.flows(st.sd, clip[:-1], clip[1:], p["iters"], levels, radius, tf32=tf32))
    return torch.cat(out)


def check(st, records, ctx):
    picks = sorted(program.host_rng(st.ctx.seed, 1).choice(
        len(records), min(ctx.params["check_batches"], len(records)), replace=False))
    want = reference_flows(st, [records[u]["pool"] for u in picks])
    if ctx.control:
        got = reference_flows(st, [records[u]["pool"] for u in picks], tf32=True)
    else:
        got = torch.from_numpy(np.concatenate([records[u]["flows"] for u in picks])).to(want.device)
    return [("flow_gap", compare.row_gap(got.reshape(-1, 2), want.reshape(-1, 2)),
             ctx.workload["limits"]["flow_gap"])]
