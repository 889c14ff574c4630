"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
nonzero without printing a result:

1. toolchain: torch, CUDA, nvcc, the card's name and power limit;
2. build: the Hopper kernels from ``surgical_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel checks: each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes (MiT-b3, 224x224, B=8), with timings;
4. slice: seeded random-init MiT-b3 EVP + MS-TCN + refiner; three synthetic
   200-frame videos in the wire format -> make_raw_feature_fn ->
   extract_to_store -> predict_and_write -> relaxed evaluation, with the
   kernel launch counts of that run and the kernel-vs-plain feature cosine;
   then the extraction rate over 3 runs of 12 batches of 200 frames;
5. result: a JSON line of per-kernel numbers, the card line, and the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 200          # the CLI's extraction batch size
VIDEOS, FRAMES = 3, 200
CHECK_B = 8          # kernel-check batch
THROUGHPUT_BATCHES, THROUGHPUT_RUNS = 12, 3  # extraction rate: 3 runs of 12 batches
# Kernel vs plain, both bf16 with the same rounding points: they differ by
# fp32 summation order, which flips an occasional bf16 rounding. Bounds are a
# few times the readings on an H100 (rel L2 1.7e-4 / 2.7e-4 / 5.4e-4 for the
# block at stages 1-3, 4.3e-3 for stage 4; max abs one bf16 ulp of outputs up
# to |y| ~ 8 for the blocks, 0.094 for stage 4), per shape:
# {stage: (rel L2 bound, max abs bound)}
BOUNDS = {1: (1e-3, 0.125), 2: (1e-3, 0.125), 3: (2e-3, 0.125), 4: (1e-2, 0.25)}
COSINE_BOUND = 0.9999  # per-frame cosine, kernel path vs plain path (read: min 0.999995)

SOURCE = "surgical_tpu_torch/csrc/mit_block.cu"


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_toolchain() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    from surgical_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    smi = smi_line()
    print(f"toolchain: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | nvcc: {nvcc}")
    print(f"toolchain: device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    return smi


def phase_build():
    from surgical_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    print(f"build: {os.path.relpath(so)} in {time.perf_counter() - t0:.2f} s")


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rand(rng, shape, scale=1.0, offset=0.0):
    t = torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))
    return t.to("cuda", torch.bfloat16).contiguous()


def _block_weights(rng, C, hidden, lead=()):
    r = lambda *s, scale=1.0, offset=0.0: _rand(rng, lead + s, scale, offset)
    return {
        "wq": r(C, C, scale=C ** -0.5), "bq": r(C, scale=0.1),
        "wo": r(C, C, scale=C ** -0.5), "bo": r(C, scale=0.1),
        "ln1_scale": r(C, scale=0.1, offset=1.0), "ln1_bias": r(C, scale=0.1),
        "ln2_scale": r(C, scale=0.1, offset=1.0), "ln2_bias": r(C, scale=0.1),
        "w1": r(C, hidden, scale=C ** -0.5), "b1": r(hidden, scale=0.1),
        "wdw": r(9, hidden, scale=1 / 3), "bdw": r(hidden, scale=0.1),
        "w2": r(hidden, C, scale=hidden ** -0.5), "b2": r(C, scale=0.1),
    }


def _compare(name, got, want, stage):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    mx = (got - want).abs().max().item()
    rel_bound, abs_bound = BOUNDS[stage]
    ok = rel <= rel_bound and mx <= abs_bound
    print(f"check {name}: rel_l2 {rel:.3e} (bound {rel_bound}) max_abs {mx:.3e} "
          f"(bound {abs_bound}) max|plain| {want.abs().max().item():.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return rel, mx


def phase_kernel_checks() -> dict:
    from surgical_tpu_torch.kernels import mit_block as mb

    rng = np.random.default_rng(SEED)
    B, res = CHECK_B, {}
    block_rows = []
    # (stage, C, heads, grid, sr): b3 at 224x224; Nkv = 49 at every stage
    for stage, C, heads, side, sr in ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2)):
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        x, k, v = _rand(rng, (B, N, C)), _rand(rng, (B, Nkv, C)), _rand(rng, (B, Nkv, C))
        w = _block_weights(rng, C, hidden)
        kw = dict(heads=heads, H=side, W=side)
        got = mb.fused_mit_block(x, k, v, w, **kw)
        want = mb.fused_mit_block_plain(x, k, v, w, **kw)
        torch.cuda.synchronize()
        shape = f"stage{stage} [B={B}, N={N}, C={C}, heads={heads}]"
        rel, mx = _compare(f"block {shape}", got, want, stage)
        ms = time_ms(lambda: mb.fused_mit_block(x, k, v, w, **kw))
        plain_ms = time_ms(lambda: mb.fused_mit_block_plain(x, k, v, w, **kw))
        print(f"time block stage{stage}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        block_rows.append({"shape": shape, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
                           "plain_ms": plain_ms})
    res["block"] = block_rows

    C, heads, side, depth, Cb, C4 = 512, 8, 7, 3, 128, 128
    N = side * side
    sw = _block_weights(rng, C, 4 * C, lead=(depth,))
    sw = {k: (t.reshape(depth, 1, -1) if t.dim() == 2 else t) for k, t in sw.items()}
    sw["ln1"] = torch.stack([sw.pop("ln1_scale")[:, 0], sw.pop("ln1_bias")[:, 0]], 1)
    sw["ln2"] = torch.stack([sw.pop("ln2_scale")[:, 0], sw.pop("ln2_bias")[:, 0]], 1)
    sw["wkv"] = _rand(rng, (depth, C, 2 * C), C ** -0.5)
    sw["bkv"] = _rand(rng, (depth, 1, 2 * C), 0.1)
    sw["lww"] = _rand(rng, (depth, Cb, C4), Cb ** -0.5)
    sw["lwb"] = _rand(rng, (depth, 1, C4), 0.1)
    sw["sharedw"] = _rand(rng, (C4, C), C4 ** -0.5)
    sw["sharedb"] = _rand(rng, (1, C), 0.1)
    sw = {k: t.contiguous() for k, t in sw.items()}
    x, base = _rand(rng, (B, N, C)), _rand(rng, (B, N, Cb))
    kw = dict(heads=heads, H=side, W=side, sr=1)
    got = mb.fused_mit_stage(x, base, sw, **kw)
    want = mb.fused_mit_stage_plain(x, base, sw, **kw)
    torch.cuda.synchronize()
    rel, mx = _compare(f"stage4 [B={B}, N={N}, C={C}, heads={heads}, depth={depth}, base]",
                       got, want, 4)
    ms = time_ms(lambda: mb.fused_mit_stage(x, base, sw, **kw))
    plain_ms = time_ms(lambda: mb.fused_mit_stage_plain(x, base, sw, **kw))
    print(f"time stage4: kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    res["stage"] = {"rel_l2": rel, "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms}
    return res


def _wire_videos(rng):
    n, S = VIDEOS * FRAMES, 224
    img = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (n, S, S, 1), dtype=np.uint8)
    flow = rng.standard_normal((n, S, S, 2), dtype=np.float32).astype(np.float16)
    return [(img[i:i + BATCH], seg[i:i + BATCH], flow[i:i + BATCH])
            for i in range(0, n, BATCH)]


def phase_slice(workdir: str) -> dict:
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MSTCNConfig,
                                                RefinerConfig)
    from surgical_tpu_torch.eval.predictions import read_phase_txt, video_txt_name
    from surgical_tpu_torch.eval.relaxed import evaluate_videos
    from surgical_tpu_torch.kernels import mit_block as mb
    import surgical_tpu_torch.models.mit_fused as mf
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.extract import (extract_features, extract_to_store,
                                                  make_raw_feature_fn)
    from surgical_tpu_torch.train.refiner import predict_and_write, predict_video
    from surgical_tpu_torch.train.temporal import VideoDataset

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    backbone = MiTEVP(BackboneConfig(), HeadConfig(), seed=SEED, device=dev)
    temporal = MultiStageTCN(MSTCNConfig(), seed=SEED + 1, device=dev)
    refiner = RefinementTransformer(RefinerConfig(), seed=SEED + 2, device=dev)
    rng = np.random.default_rng(SEED)
    batches = _wire_videos(rng)
    lengths = [FRAMES] * VIDEOS
    print(f"slice: b3 models + {VIDEOS}x{FRAMES} wire frames ready in "
          f"{time.perf_counter() - t0:.2f} s")

    feature_fn = make_raw_feature_fn(backbone)
    feature_fn(*batches[0])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    mb.reset_launches()
    store, stats = extract_to_store(feature_fn, iter(batches), lengths,
                                    feature_dim=HeadConfig().embedding_dim, batch_size=BATCH,
                                    directory=os.path.join(workdir, "lfb"),
                                    meta={"split": "smoke"})
    labels = np.concatenate([np.sort(rng.integers(0, 7, FRAMES)) for _ in range(VIDEOS)])
    starts = np.arange(VIDEOS) * FRAMES
    ds = VideoDataset(store, labels, rng.uniform(0, 5, (VIDEOS * FRAMES, 7)),
                      np.asarray(lengths), starts)
    ids = list(range(1, VIDEOS + 1))
    out_dir = os.path.join(workdir, "phase")
    metrics, preds, _ = predict_and_write(temporal, refiner, ds, out_dir, ids)
    torch.cuda.synchronize()
    launches = {"mit_block_forward": mb.fused_mit_block.launches,
                "mit_stage_forward": mb.fused_mit_stage.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    n_batches = len(batches)
    want_launches = {"mit_block_forward": 25 * n_batches, "mit_stage_forward": n_batches}
    print(f"slice: extraction {stats['frames']} frames in {stats['seconds']:.3f} s = "
          f"{stats['fps']:.1f} frames/s (batch {BATCH}, peak {peak_gib:.2f} GiB)")
    print(f"slice: launches {launches} (expected {want_launches})")
    if launches != want_launches:
        raise AssertionError("the main path did not launch every kernel as expected")
    feats = np.asarray(store.features)
    if feats.shape != (VIDEOS * FRAMES, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"features: shape {feats.shape}, finite {np.isfinite(feats).all()}")

    # per-video MS-TCN + refiner latency (host clock around synchronized runs)
    lat = []
    for i in range(VIDEOS):
        lfb = torch.tensor(ds.video_arrays(i)[0], device=dev)
        predict_video(temporal, refiner, lfb)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            predict_video(temporal, refiner, lfb)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        lat.append(float(np.median(runs)))
    print(f"slice: temporal+refiner latency per {FRAMES}-frame video (median of 5) ms: "
          + ", ".join(f"{v:.3f}" for v in lat))

    gts = [labels[s:s + FRAMES] for s in starts]
    txt = [read_phase_txt(os.path.join(out_dir, video_txt_name(v))) for v in ids]
    if [len(t) for t in txt] != lengths or any((t != p).any() for t, p in zip(txt, preds)):
        raise AssertionError("phase txts do not hold the predictions")
    res = evaluate_videos(gts, txt)
    if not np.isfinite(res.mean_acc):
        raise AssertionError("relaxed evaluation is not finite")
    print(f"slice: relaxed eval acc {res.mean_acc:.2f} jacc {res.mean_jacc:.2f} | "
          f"frame acc {metrics['acc_frame']:.4f} (random weights: only finiteness is checked)")

    # the same first batch through the plain versions of the kernels
    saved = (mf.fused_mit_block, mf.fused_mit_stage)
    mf.fused_mit_block, mf.fused_mit_stage = mb.fused_mit_block_plain, mb.fused_mit_stage_plain
    try:
        plain = feature_fn(*batches[0]).float()
    finally:
        mf.fused_mit_block, mf.fused_mit_stage = saved
    kern = torch.tensor(feats[:BATCH], device=dev)
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=-1)
    print(f"slice: per-frame cosine kernel vs plain features: min {cos.min().item():.6f} "
          f"median {cos.median().item():.6f} (bound {COSINE_BOUND})")
    if cos.min().item() < COSINE_BOUND:
        raise AssertionError("kernel-path features disagree with the plain path")
    plain_preds = predict_video(temporal, refiner, plain)[:, :7].argmax(-1).cpu().numpy()
    agree = float((plain_preds == preds[0]).mean())
    print(f"slice: phase argmax agreement kernel vs plain path, video 1: {agree:.4f} (information)")

    # extraction rate over more batches than the slice holds: the same
    # host batches in turn, through the same entry point
    n = THROUGHPUT_BATCHES * BATCH
    rates = []
    for _ in range(THROUGHPUT_RUNS):
        cycled = (batches[i % n_batches] for i in range(THROUGHPUT_BATCHES))
        feats, st = extract_features(feature_fn, cycled, n, HeadConfig().embedding_dim, BATCH)
        if not np.isfinite(feats).all():
            raise AssertionError("throughput run: features are not finite")
        rates.append(st["fps"])
    fps = float(np.median(rates))
    print(f"throughput: extraction {THROUGHPUT_RUNS} runs of {THROUGHPUT_BATCHES} batches "
          f"of {BATCH} frames, frames/s: " + ", ".join(f"{r:.1f}" for r in rates)
          + f" (median {fps:.1f})")
    return {"launches": launches, "fps": fps, "latency_ms": lat}


def main() -> int:
    smi = phase_toolchain()
    phase_build()
    checks = phase_kernel_checks()
    with tempfile.TemporaryDirectory() as workdir:
        sl = phase_slice(workdir)
    blk, stg = checks["block"], checks["stage"]
    kernels = [
        {"name": "mit_block_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:236",
         "also_replaces": "surgical_tpu/kernels/mit_block.py:449",
         "launches": sl["launches"]["mit_block_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in blk),
         "ms": sum(r["ms"] for r in blk), "plain_ms": sum(r["plain_ms"] for r in blk),
         "shapes": blk},
        {"name": "mit_stage_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:1202",
         "launches": sl["launches"]["mit_stage_forward"],
         "max_abs_err": stg["max_abs_err"], "ms": stg["ms"], "plain_ms": stg["plain_ms"]},
    ]
    if any(m.split(".")[0] in ("jax", "flax", "optax", "orbax") for m in sys.modules):
        raise AssertionError("the port's run imported JAX")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
