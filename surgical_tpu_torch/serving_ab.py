"""Other checkouts against this one on one card: the serving MiT kernels and
extraction, the training block's kernels and the training step, the
selective scan and the Mamba + refiner latency.

    python3 -m surgical_tpu_torch.serving_ab --tree parent=DIR [--tree LABEL=DIR ...]
                                             [--out FILE]

Each DIR holds another checkout of this repository (for instance ``git
archive`` of the parent commit unpacked under ``build/``). Each tree is
measured in a process of its own, which builds its own kernel library, in
the order of the ``--tree`` options, then this tree twice, then the
``--tree`` options in reverse (parent, change, change, parent for one). A
measurement times with CUDA events (20 launches after 3 warm-ups)
``fused_mit_block`` at MiT-b3 stages 1-3 and ``fused_mit_stage`` at stage 4
(with a prompt base), at B = 8 and B = 200, 224x224, bf16, on seeded inputs
that are the same in every tree, and ``fused_mit_block_packed2`` on the
stage-1 inputs (weights from ``pack_weights2``, row_chunks 2; with the
device time of each of its launches); then the extraction rate of the b3 EVP
(``make_raw_feature_fn`` + ``extract_features``, random seeded weights,
batches of 200 wire-format frames, the packed2 route off) in 3 runs of 12
batches; the three kernels of ``fused_mit_block_train``
(``block_train_forward``, ``block_train_mlp_backward``,
``block_train_attn_backward``) at the four b3 stages at B = 8 and the
training batch 88, the same way; and the untraced training step of
``BackboneTrainer(use_fused=True)`` (b3, batch 88, 250-px wire frames
cropped to 224, SGD): 5 steps after 2 warm-ups; then ``selective_scan`` on
one video of T = 200, 2000 and 6000 frames at ``MambaConfig()``'s widths
(D = 128, N = 64, fp32), the same way (with the device time of each of its
launches from torch.profiler), ``selective_scan_backward`` at T = 2000 and
6000 (fed what that tree's forward keeps for it; with the device time of
each of its launches), and the latency per
video of
``predict_video`` with a seeded ``CausalMambaModel(MambaConfig())`` and
``RefinementTransformer(RefinerConfig())`` at the same T (host clock
around synchronized calls, median of 5 after a warm-up). Each tree also
records ``cuobjdump -res-usage`` of its scan kernels (registers, shared
memory). It prints one line per measurement and a summary with the card's
name and power limit, and writes the JSON to FILE (default
``chiprun_out/serving_ab.json``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

# (stage, C, heads, grid side, sr) of MiT-b3 at 224x224; Nkv = 49 everywhere
STAGES = ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2), (4, 512, 8, 7, 1))
BATCHES = (8, 200)
TRAIN_BATCHES = (8, 88)
STAGE4_DEPTH, PROMPT = 3, 128
EXTRACT_BATCH, EXTRACT_BATCHES, EXTRACT_RUNS = 200, 12, 3
TRAIN_B, TRAIN_STEPS, TRAIN_WARMUP = 88, 7, 2
SCAN_T, SCAN_D, SCAN_N, LATENCY_RUNS = (200, 2000, 6000), 128, 64, 5
SCAN_BWD_T = (2000, 6000)
SEED = 0


def _measure(root: str) -> dict:
    """Times of the tree at ``root`` (run in a process of its own)."""
    sys.path[0] = os.path.abspath(root)
    import numpy as np
    import torch

    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn

    if not torch.cuda.is_available():
        raise SystemExit("serving_ab: no CUDA device")
    dev = torch.device("cuda")

    def rand(rng, shape, scale=1.0, offset=0.0):
        t = torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))
        return t.to(dev, torch.bfloat16).contiguous()

    def weights(rng, C, hidden, lead=()):
        r = lambda *s, scale=1.0, offset=0.0: rand(rng, lead + s, scale, offset)
        return {"wq": r(C, C, scale=C ** -0.5), "bq": r(C, scale=0.1),
                "wo": r(C, C, scale=C ** -0.5), "bo": r(C, scale=0.1),
                "ln1_scale": r(C, scale=0.1, offset=1.0), "ln1_bias": r(C, scale=0.1),
                "ln2_scale": r(C, scale=0.1, offset=1.0), "ln2_bias": r(C, scale=0.1),
                "w1": r(C, hidden, scale=C ** -0.5), "b1": r(hidden, scale=0.1),
                "wdw": r(9, hidden, scale=1 / 3), "bdw": r(hidden, scale=0.1),
                "w2": r(hidden, C, scale=hidden ** -0.5), "b2": r(C, scale=0.1)}

    def time_ms(fn, reps=20):
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

    from surgical_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    usage = subprocess.run([cuobjdump, "-res-usage", str(_build.build())], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    res = {"root": root, "kernels": {}, "scan_res_usage": [
        f"{ln.strip()} {usage[i + 1].strip()}" for i, ln in enumerate(usage[:-1])
        if "selective_scan" in ln]}
    for stage, C, heads, side, sr in STAGES:
        rng = np.random.default_rng(SEED + stage)
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        if stage < 4:
            w = weights(rng, C, hidden)
        else:
            d = STAGE4_DEPTH
            sw = weights(rng, C, hidden, lead=(d,))
            sw = {k: (t.reshape(d, 1, -1) if t.dim() == 2 else t) for k, t in sw.items()}
            sw["ln1"] = torch.stack([sw.pop("ln1_scale")[:, 0], sw.pop("ln1_bias")[:, 0]], 1)
            sw["ln2"] = torch.stack([sw.pop("ln2_scale")[:, 0], sw.pop("ln2_bias")[:, 0]], 1)
            sw["wkv"] = rand(rng, (d, C, 2 * C), C ** -0.5)
            sw["bkv"] = rand(rng, (d, 1, 2 * C), 0.1)
            sw["lww"] = rand(rng, (d, PROMPT, PROMPT), PROMPT ** -0.5)
            sw["lwb"] = rand(rng, (d, 1, PROMPT), 0.1)
            sw["sharedw"] = rand(rng, (PROMPT, C), PROMPT ** -0.5)
            sw["sharedb"] = rand(rng, (1, C), 0.1)
            sw = {k: t.contiguous() for k, t in sw.items()}
        for B in BATCHES:
            x = rand(rng, (B, N, C))
            if stage < 4:
                k, v = rand(rng, (B, Nkv, C)), rand(rng, (B, Nkv, C))
                fn = lambda: mb.fused_mit_block(x, k, v, w, heads=heads, H=side, W=side)
                name = "mit_block_forward"
            else:
                base = rand(rng, (B, N, PROMPT))
                fn = lambda: mb.fused_mit_stage(x, base, sw, heads=heads, H=side, W=side, sr=1)
                name = "mit_stage_forward"
            ms = time_ms(fn)
            res["kernels"][f"{name} stage{stage} B={B}"] = ms
            print(f"  {root}: {name} stage{stage} B={B}: {ms:.4f} ms", flush=True)
            if stage == 1:
                packed = mb.pack_weights2(w)
                call = lambda: mb.fused_mit_block_packed2(x, k, v, packed, H=side, W=side,
                                                          row_chunks=2)
                ms = time_ms(call)
                res["kernels"][f"mit_block_packed2_forward stage1 B={B}"] = ms
                per_op = _device_op_us(call)
                res.setdefault("packed2_ops_us", {})[str(B)] = per_op
                print(f"  {root}: mit_block_packed2_forward stage1 B={B}: {ms:.4f} ms; device "
                      f"us per call by kernel: {per_op}", flush=True)
            del x

    _measure_train(res, rand, weights, time_ms)
    _measure_temporal(res, time_ms)
    model = MiTEVP(BackboneConfig(), HeadConfig(), seed=SEED, device=dev)
    feature_fn = make_raw_feature_fn(model)
    rng = np.random.default_rng(SEED)
    n, S = 3 * EXTRACT_BATCH, 224
    img = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (n, S, S, 1), dtype=np.uint8)
    flow = rng.standard_normal((n, S, S, 2), dtype=np.float32).astype(np.float16)
    batches = [(img[i:i + EXTRACT_BATCH], seg[i:i + EXTRACT_BATCH], flow[i:i + EXTRACT_BATCH])
               for i in range(0, n, EXTRACT_BATCH)]
    feature_fn(*batches[0])
    torch.cuda.synchronize()
    rates = []
    for _ in range(EXTRACT_RUNS):
        cycled = (batches[i % len(batches)] for i in range(EXTRACT_BATCHES))
        out, st = extract_features(feature_fn, cycled, EXTRACT_BATCHES * EXTRACT_BATCH,
                                   HeadConfig().embedding_dim, EXTRACT_BATCH)
        if not np.isfinite(out).all():
            raise AssertionError("extraction features are not finite")
        rates.append(st["fps"])
    res["extract_fps"] = rates
    print(f"  {root}: extraction frames/s " + ", ".join(f"{r:.1f}" for r in rates), flush=True)
    return res


def train_setup(dev, use_fused: bool = True):
    """(trainer, batches): ``BackboneTrainer(use_fused=use_fused)`` on a
    seeded MiT-b3 EVP with SGD, initialized, and two seeded 250-px wire
    batches of TRAIN_B frames held on the host. Imports the package on
    ``sys.path``, so it serves any tree's measurement."""
    import numpy as np

    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, OptimConfig,
                                                TrainConfig)
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.train.backbone import BackboneTrainer

    model = MiTEVP(BackboneConfig(), HeadConfig(), seed=SEED, device=dev)
    trainer = BackboneTrainer(model, TrainConfig(optim=OptimConfig(
        name="sgd", lr=1e-3, weight_decay=0.0, grad_clip_norm=None)), use_fused=use_fused)
    trainer.init()
    rng = np.random.default_rng(SEED + 1)
    r = trainer.aug_cfg.resize
    batches = [(rng.integers(0, 256, (TRAIN_B, r, r, 3), dtype=np.uint8),
                rng.integers(0, 256, (TRAIN_B, r, r, 1), dtype=np.uint8),
                rng.standard_normal((TRAIN_B, r, r, 2), dtype=np.float32).astype(np.float16),
                rng.integers(0, 7, TRAIN_B).astype(np.int32),
                rng.uniform(0, 1, (TRAIN_B, 7)).astype(np.float32)) for _ in range(2)]
    return trainer, batches


def _measure_train(res: dict, rand, weights, time_ms) -> None:
    """The train kernels per stage and batch, then the untraced step."""
    import numpy as np
    import torch

    from surgical_tpu_torch.kernels import mit_block as mb

    dev = torch.device("cuda")
    for stage, C, heads, side, sr in STAGES:
        rng = np.random.default_rng(SEED + 10 + stage)
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        w = weights(rng, C, hidden)
        kw = dict(heads=heads, H=side, W=side)
        for B in TRAIN_BATCHES:
            x, xln, dy = rand(rng, (B, N, C)), rand(rng, (B, N, C)), rand(rng, (B, N, C))
            k, v = rand(rng, (B, Nkv, C)), rand(rng, (B, Nkv, C))
            m1, m2 = (torch.from_numpy((rng.uniform(size=B) < 0.9) / 0.9).float().to(dev)
                      for _ in range(2))
            _, x1 = mb.block_train_forward(x, xln, k, v, w, m1, m2, **kw)
            h2ln = mb.layer_norm(x1, w["ln2_scale"], w["ln2_bias"])
            dmlp = (dy.float() * m2[:, None, None]).to(x.dtype)
            fns = {"block_train_forward": lambda: mb.block_train_forward(
                       x, xln, k, v, w, m1, m2, **kw),
                   "block_train_mlp_backward": lambda: mb.block_train_mlp_backward(
                       h2ln, dmlp, w, H=side, W=side),
                   "block_train_attn_backward": lambda: mb.block_train_attn_backward(
                       xln, k, v, dy, m1, w, heads=heads)}
            for name, fn in fns.items():
                ms = time_ms(fn)
                res["kernels"][f"{name} stage{stage} B={B}"] = ms
                print(f"  {res['root']}: {name} stage{stage} B={B}: {ms:.4f} ms", flush=True)
            del x, xln, dy, k, v, x1, h2ln, dmlp, fns

    trainer, batches = train_setup(dev)
    trainer.train_epoch((batches[i % 2] for i in range(TRAIN_STEPS)), 0)
    steps = trainer.step_ms[TRAIN_WARMUP:]
    res["train_step_ms"] = steps
    print(f"  {res['root']}: training step ms " + ", ".join(f"{v:.2f}" for v in steps)
          + f" (median {float(np.median(steps)):.3f})", flush=True)


def _device_op_us(fn, calls: int = 10) -> dict:
    """Device time (us) per call of the kernels that ``fn`` launches, summed
    by name (launches of one name added), from torch.profiler over ``calls``
    calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            key = name.split("<")[0].split("(")[0]
            per[key] = per.get(key, 0.0) + e.device_time_total / calls
    return {k: round(v, 3) for k, v in per.items()}


def _measure_temporal(res: dict, time_ms) -> None:
    """The scan per T on seeded inputs with Mamba's ranges (dt through
    softplus, A = -exp(.)) and its backward at SCAN_BWD_T, then Mamba +
    refiner latency per video."""
    import numpy as np
    import torch

    from surgical_tpu_torch.core.config import MambaConfig, RefinerConfig
    from surgical_tpu_torch.kernels import selective_scan as ss
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.refiner import predict_video

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    A, Dv = -torch.exp(0.5 * f(SCAN_D, SCAN_N) + 1.0), f(SCAN_D)
    for T in SCAN_T:
        x, B, C = f(1, T, SCAN_D), f(1, T, SCAN_N), f(1, T, SCAN_N)
        dt = torch.nn.functional.softplus(f(1, T, SCAN_D) - 3.0)
        ms = time_ms(lambda: ss.selective_scan(x, dt, A, B, C, Dv))
        res["kernels"][f"selective_scan_forward T={T}"] = ms
        per_op = _device_op_us(lambda: ss.selective_scan(x, dt, A, B, C, Dv))
        res.setdefault("scan_forward_ops_us", {})[str(T)] = per_op
        print(f"  {res['root']}: selective_scan_forward T={T}: {ms:.4f} ms; device us per call "
              f"by kernel: {per_op}", flush=True)
        if T not in SCAN_BWD_T:
            continue
        dy = f(1, T, SCAN_D)
        # what the tree's forward keeps for its backward: the sub-chunk states,
        # or (the first design) the chunk pairs
        if "states" in inspect.signature(ss.selective_scan_forward).parameters:
            kept = ss.selective_scan_forward(x, dt, A, B, C, Dv, states=True)[1]
        else:
            kept = ss.selective_scan_forward(x, dt, A, B, C, Dv)[1]
        call = lambda: ss.selective_scan_backward(x, dt, A, B, C, Dv, dy, kept)
        ms = time_ms(call)
        res["kernels"][f"selective_scan_backward T={T}"] = ms
        per_op = _device_op_us(call)
        res.setdefault("scan_backward_ops_us", {})[str(T)] = per_op
        print(f"  {res['root']}: selective_scan_backward T={T}: {ms:.4f} ms; device us per "
              f"call by kernel: {per_op}", flush=True)
    mamba = CausalMambaModel(MambaConfig(), seed=SEED + 3, device=dev)
    refiner = RefinementTransformer(RefinerConfig(), seed=SEED + 4, device=dev)
    res["mamba_refiner_ms"] = {}
    for T in SCAN_T:
        lfb = f(T, RefinerConfig().f_dim)
        predict_video(mamba, refiner, lfb)
        times = []
        for _ in range(LATENCY_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            predict_video(mamba, refiner, lfb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        res["mamba_refiner_ms"][str(T)] = times
        print(f"  {res['root']}: Mamba + refiner T={T} ms " + ", ".join(f"{v:.3f}" for v in times)
              + f" (median {float(np.median(times)):.3f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout to measure, e.g. parent=build/parent")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "serving_ab.json"))
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        print("RESULT " + json.dumps(_measure(args.measure)), flush=True)
        return 0
    if not args.tree or any("=" not in t for t in args.tree):
        ap.error("give at least one --tree LABEL=DIR")
    trees = dict(t.split("=", 1) for t in args.tree)
    trees["change"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    others = [t.split("=", 1)[0] for t in args.tree]
    order = (*others, "change", "change", *reversed(others))
    runs = []
    for label in order:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure",
                               os.path.abspath(trees[label])], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"serving_ab: the {label} measurement failed")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        runs.append({"tree": label, "seconds": time.perf_counter() - t,
                     **json.loads(line[len("RESULT "):])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"serving_ab on {smi} (order {', '.join(order)})")
    for r in runs[:2]:
        print(f"  {r['tree']} scan kernels: " + " | ".join(r["scan_res_usage"]))
    for key in runs[0]["kernels"]:
        vals = " / ".join(f"{r['tree']} {r['kernels'][key]:.4f}" for r in runs)
        print(f"  {key} ms: {vals}")
    med = lambda v: sorted(v)[len(v) // 2]
    print("  extraction frames/s (median of 3 runs each): " + " / ".join(
        f"{r['tree']} {med(r['extract_fps']):.1f}" for r in runs))
    print("  training step ms (median of 5 steps each): " + " / ".join(
        f"{r['tree']} {med(r['train_step_ms']):.3f}" for r in runs))
    for B in BATCHES:
        print(f"  mit_block_packed2_forward B={B} device us per call by kernel: " + " / ".join(
            f"{r['tree']} {r['packed2_ops_us'][str(B)]}" for r in runs))
    for T in SCAN_BWD_T:
        print(f"  selective_scan_backward T={T} device us per call by kernel: " + " / ".join(
            f"{r['tree']} {r['scan_backward_ops_us'][str(T)]}" for r in runs))
    for T in SCAN_T:
        print(f"  Mamba + refiner T={T} ms (median of {LATENCY_RUNS}): " + " / ".join(
            f"{r['tree']} {med(r['mamba_refiner_ms'][str(T)]):.3f}" for r in runs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
