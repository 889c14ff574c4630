"""Offline per-video prediction (``predict`` / ``evaluate``): one video's
stored features in, per-frame phase and anticipation out.

A closed loop, one video per request, through ``predict_video`` as
``evaluate`` calls it: the video's float32 features in host memory (as a
``FeatureStore`` returns them) copied to the card, the temporal model's last
stage and the refiner, the outputs back on the host and split into the
phase argmax and the anticipation. The videos' lengths are a fixed set
(Cholec80's 1.7k-6k frames at 1 fps) that every seed plays in its own
order; the features are drawn from the seed.

The check draws ``check_videos`` of the window's requests from the seed,
the longest among them, and holds their outputs to the fp32 reference's
(``output_gap``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import compare, files, program, weights
from harness.trace import span
from reference import temporal, work
from traffic.stream import temporal_flops, video_plan


def setup(ctx):
    p, dev, conf = ctx.params, ctx.device, ctx.config
    with ctx.phase("weights"):
        tmodel, sd_t = program.temporal(conf, ctx.seed, dev)
        rmodel, sd_r = program.refiner(conf, ctx.seed, dev)
    predict = files.resolve("surgical_tpu_torch.train.refiner:predict_video")
    lengths = video_plan(ctx.seed, p["video_lengths"])
    g = weights.generator(ctx.seed, "features", dev)
    f_dim = conf["refiner"]["config"]["f_dim"]
    with ctx.phase("features"):
        feats = [(torch.randn(T, f_dim, generator=g, device=dev).abs() * p["feature_scale"]
                  ).cpu().numpy() for T in lengths]
    with ctx.phase("flop count"):
        flops = temporal_flops(conf, sd_t, sd_r)
    st = SimpleNamespace(ctx=ctx, models=(tmodel, rmodel), sd=(sd_t, sd_r), predict=predict,
                         feats=feats, lengths=lengths, flops=flops)
    with ctx.phase("warm-up"):
        for v in range(len(feats)):  # every length the window plays
            request(st, v)
    return st


def request(st, v):
    """One video's features on the host -> (phase argmax, anticipation,
    the outputs they come from), on the host."""
    tmodel, rmodel = st.models
    lfb = torch.tensor(st.feats[v], device=st.ctx.device)
    out = st.predict(tmodel, rmodel, lfb).cpu().numpy()
    P = st.ctx.config["backbone"]["head"]["num_phases"]
    return np.argmax(out[:, :P], axis=-1), out[:, P:], out


def unit(st, i):
    v = i % len(st.feats)
    t = time.perf_counter()
    with span("predict"):
        phase, ant, out = request(st, v)
    return {"n": len(phase), "ms": (time.perf_counter() - t) * 1e3, "video": v, "out": out}


def end_to_end(st, records, window_s):
    return {"video_ms_p95": float(np.percentile([r["ms"] for r in records], 95))}


def counts(st, records):
    return {"frames": sum(r["n"] for r in records), "videos": len(records)}


def least_s(st, records):
    dtype = st.ctx.config["dtype"]["temporal"]
    return sum(r["n"] for r in records) * st.flops / work.PEAK_FLOPS[dtype]


def release(st):
    st.models = st.predict = None


def sampled(st, records):
    """Indices of ``check_videos`` requests drawn from the seed, the
    window's longest request among them."""
    n = min(st.ctx.params["check_videos"], len(records))
    picks = set(program.host_rng(st.ctx.seed, 4).choice(len(records), n, replace=False).tolist())
    longest = max(range(len(records)), key=lambda i: records[i]["n"])
    if longest not in picks:
        picks.discard(min(picks))
        picks.add(longest)
    return sorted(picks)


def reference_outputs(st, videos, tf32=False):
    conf, dev = st.ctx.config, st.ctx.device
    sd_t, sd_r = st.sd
    kind = conf["temporal"]["kind"]
    outs = []
    with torch.no_grad(), compare.precision(tf32):
        for v in videos:
            f = torch.from_numpy(st.feats[v]).to(dev)
            outs.append(temporal.pipeline(kind, sd_t, conf["temporal"]["config"], sd_r,
                                          conf["refiner"]["config"], f))
    return torch.cat(outs)


def check(st, records, ctx):
    picks = sampled(st, records)
    videos = [records[i]["video"] for i in picks]
    want = reference_outputs(st, videos)
    if ctx.control:
        got = reference_outputs(st, videos, tf32=True)
    else:
        got = torch.from_numpy(np.concatenate([records[i]["out"] for i in picks])).to(ctx.device)
    return [("output_gap", compare.row_gap(got, want), ctx.workload["limits"]["output_gap"])]
