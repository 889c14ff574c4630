"""Where the time goes on the port's paths, on one CUDA GPU.

    python3 -m surgical_tpu_torch.profile_extract [--out chiprun_out/profile_extract.json]

At the b3 width, 224x224, batch 200, seeded random weights and synthetic
wire-format frames, it measures:

- extraction frames/s, host-fed (wire batches in pageable host memory) and
  device-resident (the same batches already on the card), each the median
  of 5 runs of 6 batches, in one process;
- a ``torch.profiler`` trace of 3 host-fed batches: device time by kernel
  kind, and the device's idle share of the traced wall time; then the same
  trace with ``models.mit_fused._ROUTE_PACKED2`` set (stage 1 on the
  lane-packed kernel);
- MS-TCN + refiner and Mamba + refiner latency per video at T = 200 / 2000 /
  6000 (median of 7), and for one T = 2000 and one T = 6000 run of each the
  device kernel count, busy time, idle share and the selective-scan kernel's
  share;
- backbone training with the fused trunk (``BackboneTrainer(use_fused=True)``,
  b3, batch 88, 224 crop, SGD): step ms (median of 5 after 2 warm-up steps)
  and peak memory, and a trace of 3 steps: device time by kernel kind, the
  three train kernels' share, and the idle share.

It prints one line per measurement and writes them all to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

SEED, BATCH, RUN_BATCHES, RUNS = 0, 200, 6, 5
TRAIN_B, TRAIN_STEPS, TRAIN_TRACED = 88, 7, 3  # step time over 5 steps after 2 warm-ups

# (kind, substrings of the device kernel name), first match wins
KINDS = (
    ("selective scan kernel", ("selective_scan_kernel",)),
    ("serving block/stage products (wgmma_linear)", ("wgmma_linear",)),
    ("serving attention kernel (attention_tc_kernel)", ("attention_tc_kernel",)),
    ("train/packed2 GEMMs (gemm_bf16)", ("gemm_bf16",)),
    ("train/packed2 attention kernel", ("attention_kernel",)),
    ("attention backward kernel", ("attention_bwd_kernel",)),
    ("dwconv kernels (+ GELU; transposed)", ("dwconv3x3",)),
    ("dk/dv fp32 -> bf16 kernel", ("f32_to_bf16",)),
    ("stage LN / SR regroup kernels", ("layernorm_kernel", "sr_patches")),
    ("packed2 lane pack/unpack kernels", ("lane_pack2",)),
    ("H2D copy", ("Memcpy HtoD",)),
    ("D2H copy", ("Memcpy DtoH",)),
    ("D2D copy", ("Memcpy DtoD",)),
    ("plain dense GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv")),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "winograd")),
    ("reductions", ("reduce", "norm")),
    ("casts and copies", ("copy", "CatArray")),
    ("elementwise", ("elementwise",)),
)


def _kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -float("inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def _trace_by_kind(evs, wall_us) -> dict:
    by_kind = {}
    for e in evs:
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end - e.time_range.start)
    busy = _busy_us(evs)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])}}


def _print_kinds(prefix, trace):
    total = sum(trace["ms_by_kind"].values())
    for k, v in trace["ms_by_kind"].items():
        print(f"{prefix}: {100 * v / total:5.1f}% {v:9.3f} ms  {k}")


def profile_train(dev, acts) -> dict:
    """BackboneTrainer(use_fused=True) at b3, batch 88, on seeded 250-px wire
    batches held on the host: step time, peak memory, and one trace."""
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, OptimConfig, TrainConfig
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.train.backbone import BackboneTrainer

    model = MiTEVP(BackboneConfig(), HeadConfig(), seed=SEED, device=dev)
    trainer = BackboneTrainer(model, TrainConfig(optim=OptimConfig(
        name="sgd", lr=1e-3, weight_decay=0.0, grad_clip_norm=None)), use_fused=True)
    trainer.init()
    rng = np.random.default_rng(SEED + 1)
    r = trainer.aug_cfg.resize
    batches = [(rng.integers(0, 256, (TRAIN_B, r, r, 3), dtype=np.uint8),
                rng.integers(0, 256, (TRAIN_B, r, r, 1), dtype=np.uint8),
                rng.standard_normal((TRAIN_B, r, r, 2), dtype=np.float32).astype(np.float16),
                rng.integers(0, 7, TRAIN_B).astype(np.int32),
                rng.uniform(0, 1, (TRAIN_B, 7)).astype(np.float32)) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_epoch((batches[i % 2] for i in range(TRAIN_STEPS)), 0)
    steps = trainer.step_ms[2:]
    med = float(np.median(steps))
    res = {"batch": TRAIN_B, "step_ms": med, "step_ms_runs": steps,
           "frames_per_s": TRAIN_B / med * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"train b3 B={TRAIN_B}: step {med:.3f} ms (median of {len(steps)} after 2 warm-up: "
          + ", ".join(f"{v:.2f}" for v in steps) + f") = {res['frames_per_s']:.1f} frames/s, "
          f"peak {res['peak_gib']:.2f} GiB")
    mb.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch((batches[i % 2] for i in range(TRAIN_TRACED)), 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = _device_events(prof)
    trace = _trace_by_kind(evs, wall_us)
    # the three train kernels: their GEMMs, dwconvs, attention backward and
    # rounding run under the wrappers' launches (the serving kernels do not
    # run in a train step)
    mine = ("gemm_bf16", "attention_kernel", "attention_bwd_kernel", "dwconv3x3", "f32_to_bf16")
    kern_us = sum(e.time_range.end - e.time_range.start for e in evs
                  if any(k in e.name for k in mine))
    trace.update(steps=TRAIN_TRACED, kernels=len(evs), train_kernels_ms=kern_us / 1e3,
                 train_kernels_share=kern_us / 1e3 / trace["busy_ms"],
                 launches={"forward": mb.block_train_forward.launches,
                           "mlp_backward": mb.block_train_mlp_backward.launches,
                           "attn_backward": mb.block_train_attn_backward.launches})
    res["trace"] = trace
    print(f"train trace: {TRAIN_TRACED} steps, {len(evs)} device kernels, wall "
          f"{trace['wall_ms']:.2f} ms, busy {trace['busy_ms']:.2f} ms, idle share "
          f"{trace['idle_share']:.4f}; train kernels {trace['train_kernels_ms']:.2f} ms = "
          f"{100 * trace['train_kernels_share']:.1f}% of busy; launches {trace['launches']}")
    _print_kinds("train trace", trace)
    return res


def _median_fps(run, reps=RUNS):
    rates = [run() for _ in range(reps)]
    return float(np.median(rates)), rates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_extract.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_extract: needs a CUDA GPU")
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MambaConfig,
                                                MSTCNConfig, RefinerConfig)
    from surgical_tpu_torch.models import mit_fused
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn
    from surgical_tpu_torch.train.refiner import predict_video

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    res = {"card": card}
    print(f"card: {card}")

    backbone = MiTEVP(BackboneConfig(), HeadConfig(), seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    S, n = 224, 3 * BATCH
    wire = (rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, S, S, 1), dtype=np.uint8),
            rng.standard_normal((n, S, S, 2), dtype=np.float32).astype(np.float16))
    host = [tuple(a[i:i + BATCH] for a in wire) for i in range(0, n, BATCH)]
    on_dev = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in host]
    fn = make_raw_feature_fn(backbone)
    fn(*host[0])
    torch.cuda.synchronize()

    def rate(batches, count=RUN_BATCHES):
        cycled = (batches[i % len(batches)] for i in range(count))
        return extract_features(fn, cycled, count * BATCH, 2048, BATCH)[1]["fps"]

    for name, batches in (("host_fed", host), ("device_resident", on_dev)):
        med, rates = _median_fps(lambda: rate(batches))
        res[f"fps_{name}"] = {"median": med, "runs": rates}
        print(f"extraction {name}: median {med:.1f} frames/s over {RUNS} runs of "
              f"{RUN_BATCHES} batches: " + ", ".join(f"{r:.1f}" for r in rates))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for key, route in (("trace", False), ("trace_packed2", True)):
        mit_fused._ROUTE_PACKED2 = route
        try:
            fn(*host[0])  # warm-up of the route's shapes
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                rate(host, len(host))
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            mit_fused._ROUTE_PACKED2 = False
        evs = _device_events(prof)
        if not evs:
            raise AssertionError("the profiler saw no device kernels")
        res[key] = t = {"frames": n, **_trace_by_kind(evs, wall_us)}
        print(f"{key}: packed2 route {'on' if route else 'off'}, {n} frames, wall "
              f"{t['wall_ms']:.2f} ms, device busy {t['busy_ms']:.2f} ms, idle share "
              f"{t['idle_share']:.4f}")
        _print_kinds(key, t)

    refiner = RefinementTransformer(RefinerConfig(), seed=SEED + 2, device=dev)
    for name, temporal in (("mstcn", MultiStageTCN(MSTCNConfig(), seed=SEED + 1, device=dev)),
                           ("mamba", CausalMambaModel(MambaConfig(), seed=SEED + 3,
                                                      device=dev))):
        res[f"{name}_ms"], res[f"{name}_trace"] = {}, {}
        for T in (200, 2000, 6000):
            lfb = torch.from_numpy(rng.standard_normal((T, 2048), dtype=np.float32)).to(dev)
            predict_video(temporal, refiner, lfb)
            runs = []
            for _ in range(7):
                torch.cuda.synchronize()
                t = time.perf_counter()
                predict_video(temporal, refiner, lfb)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t) * 1e3)
            res[f"{name}_ms"][T] = float(np.median(runs))
            print(f"{name} + refiner: T = {T}: {np.median(runs):.3f} ms (median of 7)")
            if T == 200:
                continue
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                predict_video(temporal, refiner, lfb)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            evs = _device_events(prof)
            scan_us = sum(e.time_range.end - e.time_range.start for e in evs
                          if _kind(e.name) == "selective scan kernel")
            busy = _busy_us(evs)
            res[f"{name}_trace"][T] = {"kernels": len(evs), "wall_ms": wall_us / 1e3,
                                       "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
                                       "scan_ms": scan_us / 1e3}
            print(f"{name} + refiner: T = {T} trace: {len(evs)} device kernels, wall "
                  f"{wall_us / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
                  f"{1 - busy / wall_us:.4f}, selective scan {scan_us / 1e3:.3f} ms")

    res["train"] = profile_train(dev, acts)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
