"""Offline per-video prediction through a large hybrid temporal model
(Jamba): ``video``'s traffic, with the set-up and the check of a model too
large for ``weights.build``'s single draw.

The requests, the timed unit, the end-to-end metric, the counts and the
check's sample are ``traffic/video.py``'s: a closed loop, one video of
stored fp32 features per request, in pageable host memory and copied to the
card, through ``predict_video``; the videos' lengths a fixed set that every
seed plays in its own order. Here:

- the temporal model is built on the meta device, given storage on the
  card in its configured dtype, and drawn one top-level group at a time
  (the feature projection, each layer, the final norm and the head, each
  under its own tag of the seed) with ``weights.draw_state``: one draw of the
  whole ~2.9 B parameters in fp32 with its scale and offset would take ~57
  GB at once. The weights are held in the model's dtype; the reference reads
  those same (bf16) values;
- the reference's FLOPs are counted per video length (the causal attention's
  share grows with T), on meta tensors, and ``least_s`` sums each record's;
- the check holds the outputs of ``check_videos`` of the window's requests,
  the longest among them, to ``reference/jamba.py`` and the refiner's
  reference (``output_gap``); the control computes the reference with fp8
  products in Jamba (the configuration's bf16, one precision lower) and the
  refiner under TF32 (its fp32, one lower).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from harness import compare, files, program, weights
from reference import jamba, temporal, work
from traffic.stream import video_plan
from traffic.video import counts, end_to_end, release, request, sampled, unit  # noqa: F401


def group(key: str) -> str:
    """The top-level group of a state-dict key: ``layers.<i>`` or its first
    component."""
    parts = key.split(".")
    return ".".join(parts[:2]) if parts[0] == "layers" else parts[0]


def build_temporal(config: dict, seed: int, device):
    """(the program's temporal model on ``device``, its state dict), the
    state drawn group by group under the tags ``temporal.<group>``."""
    spec = config["temporal"]
    with torch.device("meta"):
        model = files.resolve(spec["constructor"])(program.make_config(spec), device="meta")
    model.to_empty(device=device)
    sd = model.state_dict()
    groups = {}
    for k, v in sd.items():
        groups.setdefault(group(k), {})[k] = (tuple(v.shape), torch.float32)
    with torch.no_grad():
        for name, shapes in groups.items():
            for k, t in weights.draw_state(shapes, seed, f"temporal.{name}", device).items():
                sd[k].copy_(t)
    model.eval()
    return model, sd


def pipeline(sd_t, cfg_t, sd_r, cfg_r, feats, quant=None, scan=temporal.selective_scan):
    """One video's features [T, f_dim] -> refined outputs [T, out] by the
    references: Jamba, then the refiner on its outputs and the same
    features."""
    g = jamba.forward(sd_t, cfg_t, feats[None], scan, quant)[0]
    return temporal.refiner(sd_r, cfg_r, g, feats)


def video_flops(config, sd_t, sd_r, T) -> int:
    """The reference Jamba and refiner's FLOPs for one video of T frames."""
    meta = lambda sd: {k: torch.empty_like(v, device="meta") for k, v in sd.items()}
    feats = torch.empty(T, config["refiner"]["config"]["f_dim"], device="meta")
    return work.count_flops(pipeline, meta(sd_t), config["temporal"]["config"],
                            meta(sd_r), config["refiner"]["config"], feats,
                            scan=jamba.skip_scan)


def setup(ctx):
    p, dev, conf = ctx.params, ctx.device, ctx.config
    with ctx.phase("weights"):
        tmodel, sd_t = build_temporal(conf, ctx.seed, dev)
        rmodel, sd_r = program.refiner(conf, ctx.seed, dev)
    predict = files.resolve("surgical_tpu_torch.train.refiner:predict_video")
    lengths = video_plan(ctx.seed, p["video_lengths"])
    g = weights.generator(ctx.seed, "features", dev)
    f_dim = conf["refiner"]["config"]["f_dim"]
    with ctx.phase("features"):
        feats = [(torch.randn(T, f_dim, generator=g, device=dev).abs() * p["feature_scale"]
                  ).cpu().numpy() for T in lengths]
    with ctx.phase("flop count"):
        flops = {T: video_flops(conf, sd_t, sd_r, T) for T in sorted(set(lengths))}
    st = SimpleNamespace(ctx=ctx, models=(tmodel, rmodel), sd=(sd_t, sd_r), predict=predict,
                         feats=feats, lengths=lengths, flops=flops)
    with ctx.phase("warm-up"):
        for v in range(len(feats)):  # every length the window plays
            request(st, v)
    return st


def least_s(st, records):
    dtype = st.ctx.config["dtype"]["temporal"]
    return sum(st.flops[r["n"]] for r in records) / work.PEAK_FLOPS[dtype]


def reference_outputs(st, videos, control=False):
    conf, dev = st.ctx.config, st.ctx.device
    sd_t, sd_r = st.sd
    quant = compare.fp8 if control else None
    outs = []
    with torch.no_grad(), compare.precision(control):
        for v in videos:
            f = torch.from_numpy(st.feats[v]).to(dev)
            outs.append(pipeline(sd_t, conf["temporal"]["config"], sd_r,
                                 conf["refiner"]["config"], f, quant))
    return torch.cat(outs)


def check(st, records, ctx):
    picks = sampled(st, records)
    videos = [records[i]["video"] for i in picks]
    want = reference_outputs(st, videos)
    if ctx.control:
        got = reference_outputs(st, videos, control=True)
    else:
        got = torch.from_numpy(np.concatenate([records[i]["out"] for i in picks])).to(ctx.device)
    return [("output_gap", compare.row_gap(got, want), ctx.workload["limits"]["output_gap"])]
