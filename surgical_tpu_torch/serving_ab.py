"""Other checkouts against this one on one card: the serving MiT kernels and
extraction.

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
that are the same in every tree; then the extraction rate of the b3 EVP
(``make_raw_feature_fn`` + ``extract_features``, random seeded weights,
batches of 200 wire-format frames, the packed2 route off) in 3 runs of 12
batches. It prints one line per measurement and a summary with the card's
name and power limit, and writes the JSON to FILE (default
``chiprun_out/serving_ab.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (stage, C, heads, grid side, sr) of MiT-b3 at 224x224; Nkv = 49 everywhere
STAGES = ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2), (4, 512, 8, 7, 1))
BATCHES = (8, 200)
STAGE4_DEPTH, PROMPT = 3, 128
EXTRACT_BATCH, EXTRACT_BATCHES, EXTRACT_RUNS = 200, 12, 3
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

    res = {"root": root, "kernels": {}}
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
            del x

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
    for key in runs[0]["kernels"]:
        vals = " / ".join(f"{r['tree']} {r['kernels'][key]:.4f}" for r in runs)
        print(f"  {key} ms: {vals}")
    print("  extraction frames/s (median of 3 runs each): " + " / ".join(
        f"{r['tree']} {sorted(r['extract_fps'])[len(r['extract_fps']) // 2]:.1f}" for r in runs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
