"""Offline LFB extraction: the long-term feature bank rebuilt after a
backbone change (``extract-features``).

A closed loop of ``extract_features`` calls over ``make_raw_feature_fn``,
each over ``batches_per_unit`` wire batches of ``batch`` frames (uint8
image, uint8 segmap, fp16 flow at ``size`` px) held in pageable host
memory, drawn from a seeded pool of distinct batches that is cycled; the
features come back to the host through the loop's overlapped copy.

The check draws ``check_batches`` of the window's batches from the seed and
holds all their frames' features to the fp32 reference's (``feature_gap``): the wire
dequantization, the four stages (stage 4 on the whole-stage kernel at a
batch that is a multiple of 8, hence its tanh prompt GELU), the flow fusion
and the pooled head.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import compare, files, program, weights
from harness.trace import span
from reference import mit, work


def wire_pool(seed, n, B, S, device, flow_std):
    """``n`` host batches (img u8 [B,S,S,3], seg u8 [B,S,S,1], flow f16
    [B,S,S,2]) drawn on the device from the seed, in pageable memory."""
    g = weights.generator(seed, "frames", device)
    pool = []
    for _ in range(n):
        img = torch.randint(0, 256, (B, S, S, 3), generator=g, device=device, dtype=torch.uint8)
        seg = torch.randint(0, 256, (B, S, S, 1), generator=g, device=device, dtype=torch.uint8)
        flow = (torch.randn(B, S, S, 2, generator=g, device=device) * flow_std).half()
        pool.append(tuple(t.cpu().numpy() for t in (img, seg, flow)))
    return pool


def backbone_flops(config, sd, S, **kw) -> int:
    """The reference backbone's FLOPs for one frame, counted on meta tensors."""
    meta = {k: torch.empty_like(v, device="meta") for k, v in sd.items()}
    x = lambda c: torch.empty(1, S, S, c, device="meta")
    return work.count_flops(mit.forward, meta, config["backbone"]["config"],
                            config["backbone"]["head"], x(3), x(3), x(2), **kw)


def setup(ctx):
    p, dev = ctx.params, ctx.device
    with ctx.phase("weights"):
        model, sd = program.backbone(ctx.config, ctx.seed, dev)
    extract = files.resolve("surgical_tpu_torch.train.extract:extract_features")
    fn = files.resolve("surgical_tpu_torch.train.extract:make_raw_feature_fn")(model)
    B, S = p["batch"], p["size"]
    with ctx.phase("frames"):
        pool = wire_pool(ctx.seed, p["pool_batches"], B, S, dev, p["flow_std"])
    E = ctx.config["backbone"]["head"]["embedding_dim"]
    with ctx.phase("warm-up"):
        for batch in pool[:2]:  # the kernels' build and load, the copy path
            extract(fn, [batch], B, E, B)
    with ctx.phase("flop count"):
        flops = backbone_flops(ctx.config, sd, S)
    return SimpleNamespace(ctx=ctx, model=model, fn=fn, extract=extract, sd=sd, pool=pool, E=E,
                           flops=flops)


def unit(st, i):
    p = st.ctx.params
    k, B = p["batches_per_unit"], p["batch"]
    idx = [(i * k + j) % len(st.pool) for j in range(k)]
    t = time.perf_counter()
    with span("extract_features"):
        feats, _ = st.extract(st.fn, [st.pool[j] for j in idx], k * B, st.E, B)
    return {"n": k * B, "ms": (time.perf_counter() - t) * 1e3, "feats": feats, "pool": idx}


def end_to_end(st, records, window_s):
    return {"extract_fps": sum(r["n"] for r in records) / window_s}


def counts(st, records):
    n = sum(r["n"] for r in records)
    return {"frames": n, "batches": n // st.ctx.params["batch"]}


def least_s(st, records):
    dtype = st.ctx.config["dtype"]["backbone"]
    return sum(r["n"] for r in records) * st.flops / work.PEAK_FLOPS[dtype]


def release(st):
    st.model = st.fn = st.extract = None


def sampled_batches(st, records):
    """(wire inputs as device tensors, the program's features) of
    ``check_batches`` whole batches drawn from the seed among the window's:
    a fault in one row of every batch shows in each."""
    p, dev = st.ctx.params, st.ctx.device
    B = p["batch"]
    slots = [(u, j) for u, r in enumerate(records) for j in range(len(r["pool"]))]
    picks = program.host_rng(st.ctx.seed, 1).choice(len(slots), min(p["check_batches"], len(slots)),
                                                    replace=False)
    got, wire = [], [[], [], []]
    for k in sorted(picks):
        u, j = slots[k]
        got.append(records[u]["feats"][j * B:(j + 1) * B])
        for m in range(3):
            wire[m].append(st.pool[records[u]["pool"][j]][m])
    return ([torch.from_numpy(np.concatenate(w)).to(dev) for w in wire],
            torch.from_numpy(np.concatenate(got)).to(dev))


def reference_features(st, wire, quant=None, block=16):
    cfg = st.ctx.config["backbone"]
    stage4 = "tanh" if st.ctx.params["batch"] % 8 == 0 else "erf"
    out = []
    with torch.no_grad(), compare.precision(False):
        for a in range(0, wire[0].shape[0], block):
            img, seg, flow = mit.dequant(*(w[a:a + block] for w in wire))
            out.append(mit.forward(st.sd, cfg["config"], cfg["head"], img, seg, flow,
                                   mlp_gelu="tanh", stage4_prompt_gelu=stage4, quant=quant))
    return torch.cat(out)


def check(st, records, ctx):
    wire, got = sampled_batches(st, records)
    want = reference_features(st, wire)
    if ctx.control:
        got = reference_features(st, wire, quant=compare.fp8)
    return [("feature_gap", compare.row_gap(got, want), ctx.workload["limits"]["feature_gap"])]
