"""A live feed: one frame in, its phase and anticipation outputs out.

One ``OnlineSession`` (the backbone at B = 1 on the serving graph, then the
streaming temporal model and refiner) fed 224-px wire frames (uint8 image
and segmap, fp16 flow) from a seeded pool in a closed loop: one feed, the
next frame handed in as soon as the last one's outputs are on the host. A
frame's time runs from its hand-in to its outputs on the host. The session
is reset at video boundaries: the videos' lengths are a fixed set that
every seed plays in its own order.

The check recomputes, in fp32, every frame of the window through the
reference backbone (one frame at a time, as the session runs it: stage 4
block by block with the exact prompt GELU) and each video's frames so far
through the offline causal temporal model and refiner, and holds the
session's outputs to them (``output_gap``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import compare, files, program
from harness.trace import span
from reference import mit, temporal, work
from traffic.extract import backbone_flops, wire_pool


def video_plan(seed, lengths):
    """The videos' lengths in this seed's order."""
    order = program.host_rng(seed, 2).permutation(len(lengths))
    return [int(lengths[i]) for i in order]


def temporal_flops(config, sd_t, sd_r, T=64) -> float:
    """The reference temporal model and refiner's FLOPs per frame."""
    meta = lambda sd: {k: torch.empty_like(v, device="meta") for k, v in sd.items()}
    kind = config["temporal"]["kind"]
    f_dim = config["refiner"]["config"]["f_dim"]
    feats = torch.empty(T, f_dim, device="meta")
    n = work.count_flops(lambda: temporal.refiner(
        meta(sd_r), config["refiner"]["config"],
        torch.empty(T, config["refiner"]["config"]["out_features"], device="meta"), feats))
    if kind == "mamba":
        n += work.count_flops(temporal.mamba, meta(sd_t), config["temporal"]["config"], feats[None])
    else:
        n += work.count_flops(temporal.mstcn, meta(sd_t), config["temporal"]["config"], feats)
    return n / T


def setup(ctx):
    p, dev, conf = ctx.params, ctx.device, ctx.config
    with ctx.phase("weights"):
        backbone, sd_b = program.backbone(conf, ctx.seed, dev)
        tmodel, sd_t = program.temporal(conf, ctx.seed, dev)
        rmodel, sd_r = program.refiner(conf, ctx.seed, dev)
    session = files.resolve(conf["session"])(
        backbone, files.resolve(conf["temporal"]["online"])(tmodel),
        files.resolve(conf["refiner"]["online"])(rmodel))
    S = p["size"]
    with ctx.phase("frames"):
        (img, seg, flow), = wire_pool(ctx.seed, 1, p["pool_frames"], S, dev, p["flow_std"])
    st = SimpleNamespace(ctx=ctx, session=session, models=(backbone, tmodel, rmodel),
                         sd=(sd_b, sd_t, sd_r), pool=(img, seg, flow),
                         plan=video_plan(ctx.seed, p["video_lengths"]), video=-1, left=0,
                         offset=int(program.host_rng(ctx.seed, 3).integers(p["pool_frames"])))
    with ctx.phase("warm-up"):  # the shapes, and the card's clocks under this load
        t, j = time.perf_counter(), 0
        while j < p["warmup_frames"] or time.perf_counter() - t < p["warmup_seconds"]:
            session.step(img[j % len(img)], seg[j % len(img)], flow[j % len(img)])
            j += 1
    session.reset()
    with ctx.phase("flop count"):
        st.flops = {conf["dtype"]["backbone"]: backbone_flops(conf, sd_b, S,
                                                              stage4_prompt_gelu="erf"),
                    conf["dtype"]["temporal"]: temporal_flops(conf, sd_t, sd_r)}
    return st


def unit(st, i):
    if st.left == 0:
        st.video += 1
        st.left = st.plan[st.video % len(st.plan)]
        st.session.reset()
        st.pos = 0
    j = (st.offset + i) % st.ctx.params["pool_frames"]
    img, seg, flow = (a[j] for a in st.pool)
    t = time.perf_counter()
    with span("features"):
        feat = st.session.features(img, seg, flow)
        if st.ctx.tracing and st.ctx.device.type == "cuda":  # the leg's device work in its span
            torch.cuda.synchronize(st.ctx.device)
    with span("advance"):
        out = st.session.advance(feat).cpu().numpy()
    ms = (time.perf_counter() - t) * 1e3
    rec = {"n": 1, "ms": ms, "out": out, "frame": j, "video": st.video, "pos": st.pos}
    st.left -= 1
    st.pos += 1
    return rec


def end_to_end(st, records, window_s):
    return {"stream_ms_p95": float(np.percentile([r["ms"] for r in records], 95))}


def counts(st, records):
    return {"frames": len(records)}


def least_s(st, records):
    return len(records) * sum(f / work.PEAK_FLOPS[d] for d, f in st.flops.items())


def release(st):
    st.session = st.models = None


def reference_outputs(st, records, quant=None, tf32=False, block=32):
    """The fp32 reference's outputs for every frame of ``records``."""
    conf, dev = st.ctx.config, st.ctx.device
    sd_b, sd_t, sd_r = st.sd
    cfg = conf["backbone"]
    frames = np.array([r["frame"] for r in records])
    feats = []
    with torch.no_grad(), compare.precision(False):
        for a in range(0, len(frames), block):
            wire = [torch.from_numpy(st.pool[m][frames[a:a + block]]).to(dev) for m in range(3)]
            img, seg, flow = mit.dequant(*wire)
            # one frame at a time in the session: stage 4 block by block, exact prompt GELU
            feats.append(mit.forward(sd_b, cfg["config"], cfg["head"], img, seg, flow,
                                     mlp_gelu="tanh", stage4_prompt_gelu="erf", quant=quant))
    feats = torch.cat(feats)
    videos = np.array([r["video"] for r in records])
    outs = []
    with torch.no_grad(), compare.precision(tf32):
        for v in np.unique(videos):
            sel = np.nonzero(videos == v)[0]
            outs.append(temporal.pipeline(conf["temporal"]["kind"], sd_t,
                                          conf["temporal"]["config"], sd_r,
                                          conf["refiner"]["config"], feats[sel]))
    return torch.cat(outs)


def check(st, records, ctx):
    want = reference_outputs(st, records)
    if ctx.control:
        got = reference_outputs(st, records, quant=compare.fp8, tf32=True)
    else:
        got = torch.from_numpy(np.stack([r["out"] for r in records])).to(ctx.device)
    return [("output_gap", compare.row_gap(got, want), ctx.workload["limits"]["output_gap"])]
