"""Where the time goes on the port's main path, on one CUDA GPU.

    python3 -m surgical_tpu_torch.profile_extract [--out chiprun_out/profile_extract.json]

At the b3 width, 224x224, batch 200, seeded random weights and synthetic
wire-format frames, it measures:

- extraction frames/s, host-fed (wire batches in pageable host memory) and
  device-resident (the same batches already on the card), each the median
  of 5 runs of 6 batches, in one process;
- a ``torch.profiler`` trace of 3 host-fed batches: device time by kernel
  kind, and the device's idle share of the traced wall time;
- MS-TCN + refiner and Mamba + refiner latency per video at T = 200 / 2000 /
  6000 (median of 7), and for one T = 2000 and one T = 6000 run of each the
  device kernel count, busy time, idle share and the selective-scan kernel's
  share.

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

# (kind, substrings of the device kernel name), first match wins
KINDS = (
    ("selective scan kernel", ("selective_scan_kernel",)),
    ("block/stage GEMMs (gemm_bf16)", ("gemm_bf16",)),
    ("attention kernel", ("attention_kernel",)),
    ("dwconv + GELU kernel", ("dwconv_gelu",)),
    ("stage LN / SR regroup kernels", ("layernorm_kernel", "sr_patches")),
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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rate(host, len(host))
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = _device_events(prof)
    if not evs:
        raise AssertionError("the profiler saw no device kernels")
    by_kind = {}
    for e in evs:
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end - e.time_range.start)
    busy = _busy_us(evs)
    total = sum(by_kind.values())
    res["trace"] = {"frames": n, "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                    "idle_share": 1 - busy / wall_us,
                    "ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items(),
                                                                 key=lambda kv: -kv[1])}}
    print(f"trace: {n} frames, wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
          f"idle share {1 - busy / wall_us:.4f}")
    for k, v in res["trace"]["ms_by_kind"].items():
        print(f"trace: {100 * v * 1e3 / total:5.1f}% {v:9.3f} ms  {k}")

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

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
