"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script exits
nonzero without printing a result:

1. toolchain: torch, CUDA, nvcc, the card's name and power limit;
2. build: the Hopper kernels from ``surgical_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main paths' shapes, with timings and the card's bound for the same
   work: the MiT serving kernels in bf16 (MiT-b3, 224x224, at B=8 and at
   the extraction batch B=200, the plain version timed at B=8 only; packed2
   at stage 1, B=8, with row_chunks 1 and 2, beside the block kernel's
   time), then the count of HGMMA (wgmma) instructions in the built
   library's SASS, which must not be 0; the selective scan in fp32 (d_inner
   128, d_state 64; 2000 and 6000 frames, and 3 ragged videos of 777), and
   the three kernels of the training block in bf16 at the four b3 stages
   (B=8, DropPath factors with zeros);
4. extraction slice: seeded random-init MiT-b3 EVP + MS-TCN + refiner; three
   synthetic 200-frame videos in the wire format -> make_raw_feature_fn ->
   extract_to_store -> predict_and_write -> relaxed evaluation, with the
   kernel launch counts of that run and the kernel-vs-plain feature cosine;
   then the same batches with ``mit_fused._ROUTE_PACKED2`` set (3 packed2,
   22 block and 1 stage launches per batch; feature cosine against the
   route-off features), and the extraction rate over 3 runs of 12 batches
   of 200 frames with the route off and on in turns;
5. temporal serving slice: seeded random Mamba (``MambaConfig()``) and
   refiner weights saved through ``CheckpointStore`` into a work dir whose
   ``val`` split is the extraction slice's three videos and whose ``test``
   split is two videos of 2000 and 6000 frames of random features; then
   ``cli predict --model mamba`` on test (8 scan launches per video),
   ``cli predict --model mamba --online`` on val, online vs offline logits,
   ``cli evaluate``, and Mamba + refiner latency per video;
6. backbone training: ``BackboneTrainer(use_fused=True)`` at b3, batch 88,
   224 crop, SGD, over a seeded ``FrameCache`` (3 train batches, one val and
   one test batch) for 2 epochs of ``train_epoch`` with mid-epoch
   validation, then ``evaluate``: 28 launches of each train kernel per step,
   step time, peak memory, a frozen trunk, moved trainable tensors and
   BatchNorm statistics, a checkpoint round trip with the optimizer state,
   and one step's loss and gradients against the plain train kernels;
7. extraction CLI at b3 widths through ``cli.main`` on 250-px frames: a
   synthetic Cholec80-layout corpus of 4 videos, ``prepare-data --scheme
   smoke``, a seeded ``FrameCache`` per split (``cache-frames`` too where
   Pillow is importable), seeded models saved as reference ``.pth`` files,
   ``extract-features --pretrained-evp --frame-cache --reference-pickles``
   (each store against ``extract_features`` on the same frames, the pickles
   read back), ``reference-parity --online`` on those stores (finite
   metrics, online/offline agreement), and the seconds of each verb;
8. result: a JSON line of per-kernel numbers (the serving kernels' B=200
   times and bounds beside the B=8 ones), the card line, and the last line
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

# The training block at b3's four stages, 224x224: (stage, C, heads, grid
# side, sr); Nkv = 49 at every stage.
TRAIN_STAGES = ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2), (4, 512, 8, 7, 1))
# Train kernels vs plain, both bf16 with the same rounding points (the
# backward's dS, dctx, dh and dx1 roundings included): they differ by fp32
# summation order and the dk/dv atomics' order, which flips occasional bf16
# roundings. {output: (rel L2 bound, max abs bound as a fraction of the plain
# output's max |.|)}: a few times the H100 readings at the four stages (rel
# L2 at most 8.5e-4 y, 1.7e-4 x1, 3.3e-4 dx, 2.7e-3 dxln, 2.3e-3 dk, 1.6e-3
# dv; max abs at most 1.1e-2 of max |plain|).
TRAIN_BOUNDS = {"y": (5e-3, 5e-2), "x1": (1e-3, 5e-2), "dx": (2e-3, 5e-2),
                "dxln": (1e-2, 5e-2), "dk": (1e-2, 5e-2), "dv": (1e-2, 5e-2)}

# Backbone training at the reference recipe's widths: MiT-b3 EVP
# (BackboneConfig(), HeadConfig()), bf16 compute, 250-px wire frames cropped
# to 224, batch 88 (the JAX CLI default), SGD lr 1e-3 momentum 0.9, from a
# FrameCache of TRAIN_BATCHES train batches and one val and one test batch.
TRAIN_B, TRAIN_BATCHES, TRAIN_EPOCHS = 88, 3, 2
# Trainable gradients on one batch with injected masks, kernel path vs the
# plain versions of the three train kernels (both bf16, summation orders
# differ through 28 blocks): cosine per parameter group, and the loss's
# relative difference. A few times the H100 readings (min cosine 0.9979,
# loss rel 2.7e-5).
GRAD_COS_BOUND, LOSS_REL_BOUND = 0.99, 2e-4
# Conv biases right before a train-mode BatchNorm: the batch mean removes
# them, so their gradient is zero up to rounding and they need not move.
BN_FED_BIASES = tuple(f"flow_encoder.conv{i}.bias" for i in (1, 2, 3, 4))

SOURCE = "surgical_tpu_torch/csrc/mit_block.cu"
SCAN_SOURCE = "surgical_tpu_torch/csrc/selective_scan.cu"

# Selective scan at MambaConfig() widths: (videos, frames) per check.
SCAN_D, SCAN_N = 128, 64
SCAN_SHAPES = ((1, 2000), (1, 6000), (3, 777))
# Kernel vs plain, both fp32 with expf: they differ by the summation order
# over N. A few times the H100 readings (rel L2 1.1e-7, max abs 7.6e-6 on
# outputs up to |y| ~ 46).
SCAN_BOUNDS = (1e-6, 5e-5)
TEST_LENGTHS = (2000, 6000)        # the temporal slice's test videos (Cholec80 lengths)
# The extraction CLI phase's videos in 1-fps frames: the smoke split makes
# videos 1-2 train, 3 val and 4 test; ragged last batches at batch 200.
CLI_LENGTHS = (150, 120, 200, 230)
# Max abs logits, streaming vs offline Mamba + refiner on the val videos, both
# fp32: a few times the H100 reading (7.2e-7).
ONLINE_BOUND = 5e-6

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes/s, bf16 tensor-core FLOP/s, fp32 CUDA-core FLOP/s; SFU results/s
# from 132 SMs x 16 per clock x the 1.98 GHz boost clock.
HBM_BPS, BF16_FLOPS, FP32_FLOPS, SFU_OPS = 3.35e12, 989e12, 67e12, 132 * 16 * 1.98e9


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


def bound_ms(nbytes: float, op_seconds: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BPS
    return max(t_bytes, op_seconds) * 1e3, "bytes" if t_bytes >= op_seconds else "operations"


def block_work(B, N, C, Nkv, hidden):
    """(bytes, bf16 FLOPs) of one MiT block: x, k, v read and y written once,
    its weights once; q/out/fc1/fc2 GEMMs, QK^T and PV, the 3x3 dwconv."""
    flops = B * N * (4 * C * C + 4 * C * hidden + 4 * Nkv * C + 18 * hidden)
    weights = 2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C
    return 2 * (2 * B * N * C + 2 * B * Nkv * C + weights), flops


def block_train_work(B, N, C, Nkv, hidden) -> dict:
    """(bytes, bf16 FLOPs) of each kernel of ``fused_mit_block_train``, its
    inputs read and outputs written once, its weights once. No weight
    gradients: the trunk is frozen.
    forward: x, xln, k, v in, y and x1 out; the FLOPs of ``block_work``.
    mlp_backward: h2ln, dmlp in, dh2ln (fp32) out; the fc1 and dwconv
      recompute and the fc2, dwconv and fc1 input gradients.
    attn_backward: xln, dx1, k, v in, dxln, dk, dv out; the q and QK^T
      recompute, the out-projection gradient, dP, dV, dQ, dK and the
      q-projection gradient."""
    M, kv = B * N, B * Nkv * C
    _, fwd_flops = block_work(B, N, C, Nkv, hidden)
    mlp_weights = 2 * C * hidden + 11 * hidden
    attn_weights = 2 * C * C + C
    return {
        "forward": (2 * (4 * M * C + 2 * kv + 2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C),
                    fwd_flops),
        "mlp_backward": (2 * (2 * M * C + mlp_weights) + 4 * M * C,
                         M * (6 * C * hidden + 36 * hidden)),
        "attn_backward": (2 * (3 * M * C + 4 * kv + attn_weights),
                          M * (6 * C * C + 10 * Nkv * C)),
    }


def stage_work(B, N, C, hidden, depth, Cb, C4):
    """(bytes, bf16 FLOPs) of the stage-4 kernel (sr = 1, so Nkv = N): x and
    the prompt base read, y written, every block's weights once; per block
    the prompt MLP, the kv projection and the block."""
    per_flops = B * N * (2 * Cb * C4 + 2 * C4 * C + 4 * C * C)
    _, blk_flops = block_work(B, N, C, N, hidden)
    weights = depth * (2 * C * C + 2 * C * hidden + 11 * hidden + 7 * C   # block
                       + 2 * C * C + 2 * C + Cb * C4 + C4) + C4 * C + C  # kv, prompt
    nbytes = 2 * (2 * B * N * C + B * N * Cb + weights)
    return nbytes, depth * (per_flops + blk_flops)


def scan_work(Bt, T, D, N):
    """(bytes, seconds of operations) of the selective scan: x, dt read and y
    written ([Bt, T, D] fp32), B and C read ([Bt, T, N]), A and D once; per
    (t, d, n) one exp on the SFUs and 5 fp32 flops (dt*A, the state FMA, the
    y FMA)."""
    nbytes = 4 * (3 * Bt * T * D + 2 * Bt * T * N + D * N + D)
    elems = Bt * T * D * N
    return nbytes, max(5 * elems / FP32_FLOPS, elems / SFU_OPS)


def median_ms(fn, runs: int = 5) -> float:
    """Median host-clock time of ``runs`` calls of ``fn``, each between two
    synchronizations, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


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


def _errors(name, got, want):
    """(rel L2, max abs error, max |want|) of a kernel output against its
    plain version; raises on a non-finite output."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    return rel, (got - want).abs().max().item(), want.abs().max().item()


def _compare(name, got, want, stage):
    rel, mx, scale = _errors(name, got, want)
    rel_bound, abs_bound = BOUNDS[stage]
    ok = rel <= rel_bound and mx <= abs_bound
    print(f"check {name}: rel_l2 {rel:.3e} (bound {rel_bound}) max_abs {mx:.3e} "
          f"(bound {abs_bound}) max|plain| {scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return rel, mx


def phase_kernel_checks() -> dict:
    """The serving kernels at B = CHECK_B (checked, timed, the plain version
    timed too) and at the main path's B = BATCH (checked and timed): the
    block at stages 1-3, packed2 at stage 1 (CHECK_B only), the stage
    kernel at stage 4."""
    from surgical_tpu_torch.kernels import mit_block as mb

    rng = np.random.default_rng(SEED)
    B, res = CHECK_B, {}
    block_rows, block_rows_main = [], []
    # (stage, C, heads, grid, sr): b3 at 224x224; Nkv = 49 at every stage
    for stage, C, heads, side, sr in ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2)):
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        w = _block_weights(rng, C, hidden)
        kw = dict(heads=heads, H=side, W=side)
        for b, rows in ((B, block_rows), (BATCH, block_rows_main)):
            x, k, v = _rand(rng, (b, N, C)), _rand(rng, (b, Nkv, C)), _rand(rng, (b, Nkv, C))
            got = mb.fused_mit_block(x, k, v, w, **kw)
            want = mb.fused_mit_block_plain(x, k, v, w, **kw)
            torch.cuda.synchronize()
            shape = f"stage{stage} [B={b}, N={N}, C={C}, heads={heads}]"
            rel, mx = _compare(f"block {shape}", got, want, stage)
            del got, want
            ms = time_ms(lambda: mb.fused_mit_block(x, k, v, w, **kw))
            # the plain version repeats the kernel's arithmetic: timed at CHECK_B only
            plain_ms = (time_ms(lambda: mb.fused_mit_block_plain(x, k, v, w, **kw))
                        if b == B else None)
            nbytes, flops = block_work(b, N, C, Nkv, hidden)
            bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
            print(f"time block stage{stage} B={b}: kernel {ms:.4f} ms plain "
                  f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
                  f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
            rows.append({"shape": shape, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})
            del x, k, v
    res["block"], res["block_main"] = block_rows, block_rows_main

    # packed2 at b3 stage 1: image pairs in 128-wide rows, the packed
    # weights of pack_weights2, at row_chunks 1 and 2 (the route's rule for
    # the 56x56 grid); the bound is the function's work, block_work's
    C, side, Nkv, hidden = 64, 56, 49, 256
    N = side * side
    x, k, v = _rand(rng, (B, N, C)), _rand(rng, (B, Nkv, C)), _rand(rng, (B, Nkv, C))
    w = _block_weights(rng, C, hidden)
    packed = mb.pack_weights2(w)
    nbytes, flops = block_work(B, N, C, Nkv, hidden)
    bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
    block_ms = time_ms(lambda: mb.fused_mit_block(x, k, v, w, heads=1, H=side, W=side))
    unpacked = mb.fused_mit_block(x, k, v, w, heads=1, H=side, W=side)
    packed_rows = []
    for rc in (1, 2):
        kw = dict(H=side, W=side, row_chunks=rc)
        got = mb.fused_mit_block_packed2(x, k, v, packed, **kw)
        want = mb.fused_mit_block_packed2_plain(x, k, v, packed, **kw)
        torch.cuda.synchronize()
        shape = f"stage1 [B={B}, N={N}, C={C}, Nkv={Nkv}, hidden={hidden}, row_chunks={rc}]"
        rel, mx = _compare(f"packed2 {shape}", got, want, 1)
        vs_block = _errors("packed2", got, unpacked)
        ms = time_ms(lambda: mb.fused_mit_block_packed2(x, k, v, packed, **kw))
        plain_ms = time_ms(lambda: mb.fused_mit_block_packed2_plain(x, k, v, packed, **kw))
        print(f"time packed2 rc={rc}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP) | "
              f"mit_block_forward on the same unpacked inputs {block_ms:.4f} ms (outputs "
              f"rel L2 {vs_block[0]:.3e}, max abs {vs_block[1]:.3e} apart)")
        packed_rows.append({"shape": shape, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                            "block_ms": block_ms})
    res["packed2"] = packed_rows

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
    kw = dict(heads=heads, H=side, W=side, sr=1)
    for b in (B, BATCH):
        x, base = _rand(rng, (b, N, C)), _rand(rng, (b, N, Cb))
        got = mb.fused_mit_stage(x, base, sw, **kw)
        want = mb.fused_mit_stage_plain(x, base, sw, **kw)
        torch.cuda.synchronize()
        shape = f"stage4 [B={b}, N={N}, C={C}, heads={heads}, depth={depth}, base]"
        rel, mx = _compare(shape, got, want, 4)
        ms = time_ms(lambda: mb.fused_mit_stage(x, base, sw, **kw))
        plain_ms = time_ms(lambda: mb.fused_mit_stage_plain(x, base, sw, **kw)) if b == B else None
        nbytes, flops = stage_work(b, N, C, 4 * C, depth, Cb, C4)
        bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
        print(f"time stage4 B={b}: kernel {ms:.4f} ms plain "
              f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
              f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
        res["stage" if b == B else "stage_main"] = {
            "shape": shape, "rel_l2": rel, "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by}
        del x, base, got, want
    return res


def _cuobjdump() -> str:
    """cuobjdump of the CUDA toolkit, or the copy Triton's package carries."""
    import shutil

    from surgical_tpu_torch.kernels import _build

    cands = [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                  "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("cuobjdump not found (CUDA toolkit or Triton's package)")


def phase_sass() -> int:
    """The count of HGMMA (wgmma) instructions in the built library's SASS:
    the serving products run on Hopper's warpgroup tensor-core path."""
    from surgical_tpu_torch.kernels import _build

    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"sass: {n} HGMMA instructions in {os.path.relpath(_build.build())}")
    if n == 0:
        raise AssertionError("the kernel library holds no HGMMA instruction")
    return n


def scan_inputs(rng, Bt, T, D=SCAN_D, N=SCAN_N):
    """fp32 scan inputs on the card with Mamba's ranges: dt through softplus,
    A = -exp(.) of the A_log init's size."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    dt = torch.nn.functional.softplus(f(Bt, T, D) - 3.0)
    A = -torch.exp(0.5 * f(D, N) + 1.0)
    return f(Bt, T, D), dt, A, f(Bt, T, N), f(Bt, T, N), f(D)


def phase_scan_checks() -> list:
    from surgical_tpu_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(SEED + 5)
    rows = []
    for Bt, T in SCAN_SHAPES:
        args = scan_inputs(rng, Bt, T)
        got, want = ss.selective_scan(*args), ss.selective_scan_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("selective_scan: kernel output is not finite")
        rel = ((got - want).norm() / want.norm()).item()
        mx = (got - want).abs().max().item()
        ok = rel <= SCAN_BOUNDS[0] and mx <= SCAN_BOUNDS[1]
        print(f"check scan [Bt={Bt}, T={T}, D={SCAN_D}, N={SCAN_N}]: rel_l2 {rel:.3e} "
              f"(bound {SCAN_BOUNDS[0]}) max_abs {mx:.3e} (bound {SCAN_BOUNDS[1]}) "
              f"max|plain| {want.abs().max().item():.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("selective_scan: kernel disagrees with its plain version")
        ms = time_ms(lambda: ss.selective_scan(*args))
        plain_ms = time_ms(lambda: ss.selective_scan_plain(*args), reps=3)
        nbytes, op_s = scan_work(Bt, T, SCAN_D, SCAN_N)
        bms, by = bound_ms(nbytes, op_s)
        print(f"time scan [Bt={Bt}, T={T}]: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{Bt * T * SCAN_D * SCAN_N / 1e6:.1f} M exp)")
        rows.append({"shape": f"[Bt={Bt}, T={T}, D={SCAN_D}, N={SCAN_N}]", "rel_l2": rel,
                     "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by})
    return rows


def phase_train_kernel_checks() -> dict:
    """The three kernels of fused_mit_block_train at the b3 training shapes
    (224x224, B = CHECK_B), each against its plain version on the same
    inputs: the forward's y and x1, and the backward's dx, dxln, dk, dv
    (the backward through both kernels and the plain LayerNorm-2 backward
    between them, against the whole plain backward, from the kernel's x1)."""
    from surgical_tpu_torch.kernels import mit_block as mb

    rng = np.random.default_rng(SEED + 7)
    B, rows, failed = CHECK_B, {"forward": [], "mlp_backward": [], "attn_backward": []}, []
    mb.reset_launches()
    for stage, C, heads, side, sr in TRAIN_STAGES:
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        x, xln = _rand(rng, (B, N, C)), _rand(rng, (B, N, C))
        k, v, dy = _rand(rng, (B, Nkv, C)), _rand(rng, (B, Nkv, C)), _rand(rng, (B, N, C))
        # DropPath factors at keep 0.9: some images dropped (0), the rest 1/keep
        keep = 0.9
        m1, m2 = (torch.from_numpy((rng.uniform(size=B) < keep) / keep).float().cuda()
                  for _ in range(2))
        m1[0], m2[1] = 0.0, 0.0
        w = _block_weights(rng, C, hidden)
        kw = dict(heads=heads, H=side, W=side)
        y, x1 = mb.block_train_forward(x, xln, k, v, w, m1, m2, **kw)
        want_y, want_x1 = mb.fused_mit_block_train_fwd_plain(x, xln, k, v, w, m1, m2, **kw)
        grads = mb._block_train_bwd(x1, xln, k, v, w, m1, m2, dy, **kw,
                                    mlp_bwd=mb.block_train_mlp_backward,
                                    attn_bwd=mb.block_train_attn_backward)
        want_grads = mb.fused_mit_block_train_bwd_plain(x1, xln, k, v, w, m1, m2, dy, **kw)
        torch.cuda.synchronize()
        shape = f"stage{stage} [B={B}, N={N}, C={C}, heads={heads}, Nkv={Nkv}]"
        errs = {}
        for name, got, want in zip(("y", "x1", "dx", "dxln", "dk", "dv"),
                                   (y, x1, *grads), (want_y, want_x1, *want_grads)):
            rel, mx, scale = _errors(f"train {name} {shape}", got, want)
            bound = TRAIN_BOUNDS[name]
            ok = rel <= bound[0] and mx <= bound[1] * scale
            errs[name] = (rel, mx)
            print(f"check train {name} {shape}: rel_l2 {rel:.3e} (bound {bound[0]}) max_abs "
                  f"{mx:.3e} (bound {bound[1]} x max|plain| {scale:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name} {shape}")

        # the MLP backward's inputs as the backward forms them
        h2ln = mb.layer_norm(x1, w["ln2_scale"], w["ln2_bias"])
        dmlp = (dy.float() * m2[:, None, None]).to(x.dtype)
        dx1 = grads[0]
        timed = {
            "forward": (lambda: mb.block_train_forward(x, xln, k, v, w, m1, m2, **kw),
                        lambda: mb.fused_mit_block_train_fwd_plain(x, xln, k, v, w, m1, m2, **kw),
                        ("y", "x1")),
            "mlp_backward": (lambda: mb.block_train_mlp_backward(h2ln, dmlp, w, H=side, W=side),
                             lambda: mb._mlp_bwd_plain(h2ln, dmlp, w, H=side, W=side), ("dx",)),
            "attn_backward": (lambda: mb.block_train_attn_backward(xln, k, v, dx1, m1, w,
                                                                   heads=heads),
                              lambda: mb._attn_bwd_plain(xln, k, v, dx1, m1, w, heads=heads),
                              ("dxln", "dk", "dv")),
        }
        work = block_train_work(B, N, C, Nkv, hidden)
        for kname, (kern, plain, outs) in timed.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            nbytes, flops = work[kname]
            bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
            print(f"time train {kname} stage{stage}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
            rows[kname].append({"shape": shape, "max_abs_err": max(errs[o][1] for o in outs),
                                "rel_l2": max(errs[o][0] for o in outs), "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by})
    print(f"train kernel checks: launches block_train_forward {mb.block_train_forward.launches}, "
          f"block_train_mlp_backward {mb.block_train_mlp_backward.launches}, "
          f"block_train_attn_backward {mb.block_train_attn_backward.launches} "
          "(checks and timing only; not the main path's)")
    if failed:
        raise AssertionError(f"train kernels disagree with their plain versions: {failed}")
    return rows


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
        lat.append(median_ms(lambda: predict_video(temporal, refiner, lfb)))
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

    # the packed2 route: the same batches with mit_fused._ROUTE_PACKED2 set,
    # so that stage 1 runs the lane-packed kernel (row_chunks 2 at 56x56)
    mf._ROUTE_PACKED2 = True
    try:
        feature_fn(*batches[0])  # warm-up of the route's shapes
        torch.cuda.synchronize()
        mb.reset_launches()
        route_feats, _ = extract_features(feature_fn, iter(batches), VIDEOS * FRAMES,
                                          HeadConfig().embedding_dim, BATCH)
        torch.cuda.synchronize()
        route_launches = {"mit_block_packed2_forward": mb.fused_mit_block_packed2.launches,
                          "mit_block_forward": mb.fused_mit_block.launches,
                          "mit_stage_forward": mb.fused_mit_stage.launches}
    finally:
        mf._ROUTE_PACKED2 = False
    want_route = {"mit_block_packed2_forward": 3 * n_batches,
                  "mit_block_forward": 22 * n_batches, "mit_stage_forward": n_batches}
    print(f"slice: packed2 route: launches {route_launches} (expected {want_route})")
    if route_launches != want_route:
        raise AssertionError("the packed2 route did not launch the kernels as expected")
    cos = torch.nn.functional.cosine_similarity(torch.tensor(route_feats), torch.tensor(feats),
                                                dim=-1)
    print(f"slice: per-frame cosine route on vs off features: min {cos.min().item():.6f} "
          f"median {cos.median().item():.6f} (bound {COSINE_BOUND})")
    if not np.isfinite(route_feats).all() or cos.min().item() < COSINE_BOUND:
        raise AssertionError("the packed2 route's features disagree with the route-off path")

    # extraction rate over more batches than the slice holds: the same
    # host batches in turn, through the same entry point, with the packed2
    # route off and on in turns
    n = THROUGHPUT_BATCHES * BATCH
    rates = {False: [], True: []}
    for run in range(THROUGHPUT_RUNS):
        for route in ((False, True) if run % 2 == 0 else (True, False)):
            cycled = (batches[i % n_batches] for i in range(THROUGHPUT_BATCHES))
            mf._ROUTE_PACKED2 = route
            try:
                out, st = extract_features(feature_fn, cycled, n, HeadConfig().embedding_dim,
                                           BATCH)
            finally:
                mf._ROUTE_PACKED2 = False
            if not np.isfinite(out).all():
                raise AssertionError("throughput run: features are not finite")
            rates[route].append(st["fps"])
    fps, fps_route = (float(np.median(rates[r])) for r in (False, True))
    for route, med in ((False, fps), (True, fps_route)):
        print(f"throughput: extraction, packed2 route {'on' if route else 'off'}, "
              f"{THROUGHPUT_RUNS} runs of {THROUGHPUT_BATCHES} batches of {BATCH} frames, "
              f"frames/s: " + ", ".join(f"{r:.1f}" for r in rates[route]) + f" (median {med:.1f})")
    return {"launches": launches, "route_launches": route_launches, "fps": fps,
            "fps_route": fps_route, "latency_ms": lat, "lfb": os.path.join(workdir, "lfb"),
            "labels": labels}


class _WireFrames:
    """Seeded wire-format frames (uint8 images and segmaps, f16 flow at 250
    px) and Cholec80-layout labels, as a ``FrameCache.build`` source."""

    resize, with_flow, ant_cols = 250, True, (8, 15)

    def __init__(self, n, rng, labels=None):
        r = self.resize
        self.img = rng.integers(0, 256, (n, r, r, 3), dtype=np.uint8)
        self.seg = rng.integers(0, 256, (n, r, r, 1), dtype=np.uint8)
        self.flow = rng.standard_normal((n, r, r, 2), dtype=np.float32).astype(np.float16)
        if labels is None:
            labels = np.concatenate([rng.integers(0, 7, (n, 1)), rng.integers(0, 2, (n, 7)),
                                     rng.uniform(0, 1, (n, 7))], 1).astype(np.float32)
        self.labels = labels

    def __len__(self):
        return len(self.img)

    def frames(self, idx):
        return (self.img[idx], self.seg[idx], self.flow[idx],
                self.labels[idx, 0].astype(np.int32), self.labels[idx, 8:15])


def phase_train(workdir: str) -> dict:
    """BackboneTrainer(use_fused=True) at b3, batch 88: two epochs of
    train_epoch over a FrameCache (ClipSampler -> prefetch_batches), with
    mid-epoch validation, then evaluate; launch counts, step time, peak
    memory, what moved and what did not, a checkpoint round trip, and one
    step's gradients against the plain versions of the train kernels."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, OptimConfig, TrainConfig
    from surgical_tpu_torch.core.rng import generator
    from surgical_tpu_torch.data.datasets import (ClipSampler, FrameCache, clip_start_indices,
                                                  prefetch_batches)
    from surgical_tpu_torch.data.transforms import draw_params
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mit_train import draw_masks
    from surgical_tpu_torch.train.backbone import BackboneTrainer, is_trainable

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 8)
    caches = {name: FrameCache.build(_WireFrames(n, rng), os.path.join(workdir, "frames", name))
              for name, n in (("train", TRAIN_BATCHES * TRAIN_B), ("val", TRAIN_B),
                              ("test", TRAIN_B))}
    cfg, head_cfg = BackboneConfig(), HeadConfig()
    model = MiTEVP(cfg, head_cfg, seed=SEED, device=dev)
    tcfg = TrainConfig(optim=OptimConfig(name="sgd", lr=1e-3, weight_decay=0.0,
                                         grad_clip_norm=None))
    trainer = BackboneTrainer(model, tcfg, val_every=TRAIN_BATCHES, use_fused=True)
    opt = trainer.init()
    try:
        import PIL  # noqa: F401
        pil = "importable"
    except ImportError:
        pil = "not importable"
    print(f"train: b3 model, frame caches (train {TRAIN_BATCHES}x{TRAIN_B}, val {TRAIN_B}, "
          f"test {TRAIN_B} frames) ready in {time.perf_counter() - t0:.2f} s; data route: "
          f"FrameCache memmaps -> ClipSampler -> prefetch_batches (PIL {pil}; the PIL-decoded "
          "cli train-backbone runs in the CPU tests)")

    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = lambda name, idx: prefetch_batches(caches[name], idx, TRAIN_B)
    n_train = len(caches["train"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mb.reset_launches()
    epochs, step_ms = [], []
    for epoch in range(TRAIN_EPOCHS):
        idx = ClipSampler(1, clip_start_indices(1, [n_train])).indices(epoch=epoch, shuffle=True)
        tm = trainer.train_epoch(batches("train", idx), epoch,
                                 val_batches=list(batches("val", np.arange(TRAIN_B))))
        epochs.append(tm)
        step_ms += trainer.step_ms
    torch.cuda.synchronize()
    launches = {"mit_block_train_forward": mb.block_train_forward.launches,
                "mit_block_train_mlp_backward": mb.block_train_mlp_backward.launches,
                "mit_block_train_attn_backward": mb.block_train_attn_backward.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = TRAIN_EPOCHS * TRAIN_BATCHES
    blocks = sum(cfg.depths)
    want = {k: blocks * steps for k in launches}
    med = float(np.median(step_ms[1:]))  # the first step is the warm-up
    print("train: step ms " + ", ".join(f"{v:.2f}" for v in step_ms)
          + f"; median after warm-up {med:.3f} ms = {TRAIN_B / med * 1e3:.1f} frames/s; "
          f"peak memory {peak_gib:.2f} GiB")
    for e, tm in enumerate(epochs):
        print(f"train: epoch {e}: loss {tm['train_loss']:.4f} acc {tm['train_acc']:.4f} "
              f"{tm['frames_per_s']:.1f} frames/s over the epoch (mid-epoch validation included)")
    print(f"train: launches {launches} (expected {want}: {blocks} per kernel per step)")
    if launches != want:
        raise AssertionError("the training path did not launch every train kernel 28 times "
                             "per step")
    if not all(np.isfinite(tm["train_loss"]) for tm in epochs):
        raise AssertionError("train loss is not finite")

    after = model.state_dict()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    trunk_moved = [k for k in moved if not is_trainable(k)]
    still = sorted(trainable - moved - set(BN_FED_BIASES))
    bn_moved = [k for k in after if k.endswith(("running_mean", "running_var")) and k in moved]
    n_bn = sum(k.endswith(("running_mean", "running_var")) for k in after)
    print(f"train: {len(trainable & moved)} of {len(trainable)} trainable tensors moved "
          f"(not required: {', '.join(BN_FED_BIASES)}); trunk tensors moved: "
          f"{len(trunk_moved)} of {sum(not is_trainable(k) for k in after)}; BatchNorm "
          f"statistics moved: {len(bn_moved)} of {n_bn}")
    if trunk_moved or still or len(bn_moved) != n_bn:
        raise AssertionError(f"trunk moved {trunk_moved[:5]}, trainable still {still[:5]}, "
                             f"BN statistics moved {len(bn_moved)} of {n_bn}")

    ev = trainer.evaluate(batches("test", np.arange(TRAIN_B)), num_each=[TRAIN_B])
    if not all(np.isfinite(ev[k]) for k in ("acc", "precision_macro", "recall_macro")):
        raise AssertionError(f"evaluate: metrics not finite: {ev}")
    print(f"train: evaluate on {TRAIN_B} test frames (serving graph): acc {ev['acc']:.4f} "
          f"acc_video {ev['acc_video']:.4f} (random weights: only finiteness is checked)")

    # checkpoint round trip: parameters, BatchNorm statistics, optimizer state
    store = CheckpointStore(os.path.join(workdir, "ckpt", "backbone"))
    store.save(TRAIN_EPOCHS - 1, model.state_dict(), metrics={"val_acc": ev["acc"]},
               aux={"optimizer": opt.state_dict()})
    model2 = MiTEVP(cfg, head_cfg, seed=SEED + 9, device=dev)
    trainer2 = BackboneTrainer(model2, tcfg, use_fused=True)
    opt2 = trainer2.init()
    store.restore(TRAIN_EPOCHS - 1, model2, dev)
    opt2.load_state_dict(store.restore_aux(TRAIN_EPOCHS - 1)["optimizer"])
    sd2 = model2.state_dict()
    same_model = all(torch.equal(sd2[k], v) for k, v in model.state_dict().items())
    st1, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    same_opt = st1.keys() == st2.keys() and all(
        torch.equal(st1[i]["momentum_buffer"], st2[i]["momentum_buffer"]) for i in st1)
    print(f"train: checkpoint round trip: model {'equal' if same_model else 'DIFFERS'}, "
          f"optimizer state ({len(st1)} momentum buffers) {'equal' if same_opt else 'DIFFERS'}")
    if not (same_model and same_opt):
        raise AssertionError("the backbone checkpoint does not round-trip")
    del model2, trainer2, opt2

    # one batch, the same augmentation and masks, through the train kernels
    # and through their plain versions: loss and trainable gradients
    img, seg, flow, labels, ant = caches["train"].frames(np.arange(TRAIN_B))
    ap = draw_params(generator(SEED, 0, purpose="augment", device=dev), trainer.aug_cfg, TRAIN_B)
    masks = draw_masks(cfg, head_cfg, TRAIN_B, generator(SEED, 0, purpose="droppath", device=dev))

    def grads():
        out, _ = trainer.loss_and_grad(img, seg, flow, labels, ant, aug_params=ap, masks=masks)
        groups = {}
        for n, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault(n.split(".")[0], []).append(p.grad.flatten())
        return out["loss"].item(), {g: torch.cat(v) for g, v in groups.items()}

    loss_k, g_k = grads()
    saved = (mb.block_train_forward, mb.block_train_mlp_backward, mb.block_train_attn_backward)
    mb.block_train_forward = mb.fused_mit_block_train_fwd_plain
    mb.block_train_mlp_backward = mb._mlp_bwd_plain
    mb.block_train_attn_backward = mb._attn_bwd_plain
    try:
        loss_p, g_p = grads()
    finally:
        mb.block_train_forward, mb.block_train_mlp_backward, mb.block_train_attn_backward = saved
    model.zero_grad(set_to_none=True)
    cos = {g: torch.nn.functional.cosine_similarity(g_k[g], g_p[g], dim=0).item() for g in g_k}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"train: kernel vs plain path on one batch: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(rel {loss_rel:.2e}, bound {LOSS_REL_BOUND}); gradient cosine per group "
          + ", ".join(f"{g} {c:.6f}" for g, c in cos.items()) + f" (bound {GRAD_COS_BOUND})")
    if loss_rel > LOSS_REL_BOUND or min(cos.values()) < GRAD_COS_BOUND:
        raise AssertionError("the training path's kernels disagree with their plain versions")
    return {"launches": launches, "step_ms": med, "fps": TRAIN_B / med * 1e3,
            "peak_gib": peak_gib, "grad_cos": cos, "loss_rel": loss_rel}


def _index_split(work, split, labels_phase, lengths, ids, rng):
    """index/<split>_*.npy in the CLI's layout: [phase, 7 tools, 7 ant]."""
    idx = os.path.join(work, "index")
    os.makedirs(idx, exist_ok=True)
    n = len(labels_phase)
    labels = np.concatenate([np.asarray(labels_phase, np.float32)[:, None],
                             rng.integers(0, 2, (n, 7)), rng.uniform(0, 1, (n, 7))], 1)
    np.save(os.path.join(idx, f"{split}_labels.npy"), labels)
    np.save(os.path.join(idx, f"{split}_num_each.npy"), np.asarray(lengths))
    np.save(os.path.join(idx, f"{split}_video_ids.npy"), np.asarray(ids, np.int64))


def phase_temporal(workdir: str, slice_res: dict) -> dict:
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import MambaConfig, RefinerConfig
    from surgical_tpu_torch.data.feature_store import FeatureStore
    from surgical_tpu_torch.eval.predictions import read_phase_txt, video_txt_name, write_phase_txt
    from surgical_tpu_torch.kernels import selective_scan as ss
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.online import OnlineMamba, OnlineRefiner, run_pipeline
    from surgical_tpu_torch.train.refiner import predict_video

    t0 = time.perf_counter()
    work, rng = os.path.join(workdir, "temporal"), np.random.default_rng(SEED + 6)
    gt_dir = os.path.join(workdir, "gt")
    val = FeatureStore.open(slice_res["lfb"])
    val_ids, test_ids = list(range(1, VIDEOS + 1)), [41, 42]
    FeatureStore.create(os.path.join(work, "lfb", "val"), np.asarray(val.features),
                        val.lengths, meta={"split": "val"})
    _index_split(work, "val", slice_res["labels"], val.lengths, val_ids, rng)
    n = sum(TEST_LENGTHS)
    test_feats = rng.standard_normal((n, 2048)).astype(np.float16).astype(np.float32)
    FeatureStore.create(os.path.join(work, "lfb", "test"), test_feats, TEST_LENGTHS,
                        meta={"split": "test"})
    test_labels = np.concatenate([np.sort(rng.integers(0, 7, L)) for L in TEST_LENGTHS])
    _index_split(work, "test", test_labels, TEST_LENGTHS, test_ids, rng)
    for vid, s, L in zip(test_ids, np.cumsum((0,) + TEST_LENGTHS[:-1]), TEST_LENGTHS):
        write_phase_txt(os.path.join(gt_dir, video_txt_name(vid)), test_labels[s:s + L])

    mamba = CausalMambaModel(MambaConfig(), seed=SEED + 3)
    refiner = RefinementTransformer(RefinerConfig(), seed=SEED + 4)
    CheckpointStore(os.path.join(work, "ckpt", "temporal")).save(
        0, mamba.state_dict(), metrics={"val_acc": 0.0}, config={"model": "mamba"})
    CheckpointStore(os.path.join(work, "ckpt", "refiner")).save(
        0, refiner.state_dict(), metrics={"val_acc": 0.0})
    print(f"temporal: work dir (val {val.lengths.tolist()}, test {list(TEST_LENGTHS)} frames) "
          f"and MambaConfig() + RefinerConfig() checkpoints ready in "
          f"{time.perf_counter() - t0:.2f} s")

    # offline predict through the CLI: the main path of this slice
    ss.reset_launches()
    t = time.perf_counter()
    if cli.main(["predict", "--work", work, "--split", "test", "--model", "mamba"]) != 0:
        raise AssertionError("cli predict --model mamba failed")
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t
    launches = ss.selective_scan.launches
    want = mamba.cfg.layers * len(TEST_LENGTHS)
    print(f"temporal: cli predict --model mamba on {len(TEST_LENGTHS)} test videos in "
          f"{predict_s:.3f} s; selective_scan launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the Mamba path did not launch the scan kernel 8 times per video")
    test = FeatureStore.open(os.path.join(work, "lfb", "test"))
    for i, vid in enumerate(test_ids):
        lfb = torch.tensor(np.asarray(test.video(i)), device="cuda")
        out = predict_video(mamba, refiner, lfb)
        if out.shape != (TEST_LENGTHS[i], 14) or not torch.isfinite(out).all():
            raise AssertionError(f"video {vid}: outputs {tuple(out.shape)} not finite or misshapen")
        txt = read_phase_txt(os.path.join(work, "output", "Test", video_txt_name(vid)))
        if not np.array_equal(txt, out[:, :7].argmax(-1).cpu().numpy()):
            raise AssertionError(f"video {vid}: the phase txt does not hold the predictions")

    # streaming through the CLI, then streaming vs offline logits
    if cli.main(["predict", "--work", work, "--split", "val", "--model", "mamba",
                 "--online"]) != 0:
        raise AssertionError("cli predict --model mamba --online failed")
    t_on, r_on = OnlineMamba(mamba), OnlineRefiner(refiner)
    worst, agree = 0.0, []
    for i, vid in enumerate(val_ids):
        lfb = torch.tensor(np.asarray(val.video(i)), dtype=torch.float32, device="cuda")
        offline, online = predict_video(mamba, refiner, lfb), run_pipeline(t_on, r_on, lfb)
        worst = max(worst, (offline - online).abs().max().item())
        agree.append((offline[:, :7].argmax(-1) == online[:, :7].argmax(-1)).float().mean().item())
        txt = read_phase_txt(os.path.join(work, "output", "Val", video_txt_name(vid)))
        if not np.array_equal(txt, online[:, :7].argmax(-1).cpu().numpy()):
            raise AssertionError(f"val video {vid}: the online txt does not hold its predictions")
    print(f"temporal: online vs offline Mamba + refiner on {VIDEOS} val videos: max abs "
          f"logits {worst:.3e} (bound {ONLINE_BOUND}), argmax agreement "
          + ", ".join(f"{a:.4f}" for a in agree))
    if not worst <= ONLINE_BOUND:
        raise AssertionError("streaming Mamba disagrees with the offline path")

    if cli.main(["evaluate", "--gt", gt_dir, "--pred", os.path.join(work, "output", "Test"),
                 "--first", str(test_ids[0]), "--last", str(test_ids[-1])]) != 0:
        raise AssertionError("cli evaluate failed")

    # Mamba + refiner latency per video, with the kernel and (for
    # information) with the plain scan in its place
    videos = {FRAMES: torch.tensor(np.asarray(val.video(0)), dtype=torch.float32, device="cuda")}
    for i, L in enumerate(TEST_LENGTHS):
        videos[L] = torch.tensor(np.asarray(test.video(i)), device="cuda")
    lat, lat_plain = {}, {}
    for L, lfb in videos.items():
        lat[L] = median_ms(lambda: predict_video(mamba, refiner, lfb))
    kernel = ss.selective_scan
    ss.selective_scan = ss.selective_scan_plain
    try:
        for L, lfb in videos.items():
            lat_plain[L] = median_ms(lambda: predict_video(mamba, refiner, lfb))
    finally:
        ss.selective_scan = kernel
    print("temporal: Mamba + refiner latency per video (median of 5) ms: "
          + ", ".join(f"T={L} {lat[L]:.3f} (plain scan {lat_plain[L]:.3f})" for L in lat))
    return {"launches": launches, "online_max_abs": worst, "latency_ms": lat,
            "latency_plain_ms": lat_plain}


def _write_phase_annotations(root: str, lengths, rng) -> None:
    """Cholec80-layout annotations: phase_annotations/video<NN>-phase.txt,
    one ``frame<TAB>Phase`` row per 25-fps frame, ``lengths`` 1-fps frames
    per video, phases sorted as in a procedure."""
    from surgical_tpu_torch.core.config import PHASE_NAMES

    d = os.path.join(root, "phase_annotations")
    os.makedirs(d, exist_ok=True)
    for v, n in enumerate(lengths, start=1):
        phases = np.sort(rng.integers(0, len(PHASE_NAMES), n * 25))
        with open(os.path.join(d, f"video{v:02d}-phase.txt"), "w") as f:
            f.write("Frame\tPhase\n")
            f.writelines(f"{i}\t{PHASE_NAMES[p]}\n" for i, p in enumerate(phases))


def _write_frames(root: str, paths, rng) -> None:
    """Small JPEG frames and segmaps at the indexed paths (the Cholec80
    layout: cutMargin/<v>/<frame>.jpg, segmaps under ss_Bimasks_pos_ep10)."""
    from PIL import Image

    for p in paths:
        for path in (p, p.replace("cutMargin", "ss_Bimasks_pos_ep10")):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(path)


def phase_extract_cli(workdir: str, cfg=None, head_cfg=None, model_flags=(), device="cuda",
                      lengths=CLI_LENGTHS, batch=BATCH) -> dict:
    """The extraction CLI at b3 widths (``BackboneConfig()``,
    ``HeadConfig()``) through ``cli.main``: a synthetic Cholec80-layout
    corpus -> ``prepare-data --scheme smoke``; a seeded ``FrameCache`` per
    split written here (and ``cache-frames`` over JPEGs when Pillow is
    importable); seeded port models saved as reference-format ``.pth``
    files -> ``extract-features --pretrained-evp --frame-cache
    --reference-pickles`` (each store against ``extract_features`` run
    directly on the same frames, each pickle read back) -> ``reference-parity
    --online`` on those stores. ``cfg``, ``head_cfg``, ``model_flags`` and
    ``device`` size the phase down for a rehearsal on the CPU."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MSTCNConfig,
                                                RefinerConfig)
    from surgical_tpu_torch.data.datasets import FrameCache, prefetch_batches
    from surgical_tpu_torch.data.feature_store import FeatureStore
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn

    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    rng = np.random.default_rng(SEED + 11)
    root, work = os.path.join(workdir, "cli", "cholec80"), os.path.join(workdir, "cli", "work")
    cache_root = os.path.join(work, "frame_cache")
    seconds = {}

    def run(verb, *args):
        t = time.perf_counter()
        if cli.main([verb, *args]) != 0:
            raise AssertionError(f"cli {verb} failed")
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[verb] = time.perf_counter() - t

    _write_phase_annotations(root, lengths, rng)
    run("prepare-data", "--root", root, "--out", work, "--num-videos", str(len(lengths)),
        "--scheme", "smoke")
    idx = os.path.join(work, "index")
    splits = ("train", "val", "test")
    caches = {}
    for split in splits:
        labels = np.load(os.path.join(idx, f"{split}_labels.npy"))
        caches[split] = FrameCache.build(_WireFrames(len(labels), rng, labels),
                                         os.path.join(cache_root, split))
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    if pil:
        with open(os.path.join(idx, "val_paths.json")) as f:
            _write_frames(root, json.load(f), rng)
        run("cache-frames", "--work", work, "--out", os.path.join(work, "pil_cache"),
            "--splits", "val")
        fc = FrameCache(os.path.join(work, "pil_cache", "val"))
        if (len(fc), fc.meta["resize"], fc.meta["with_flow"]) != (len(caches["val"]), 250, True):
            raise AssertionError(f"cache-frames: {len(fc)} frames, meta {fc.meta}")
    pil_note = ("importable: cache-frames ran on the val split's JPEGs" if pil
                else "not importable: cache-frames not run")
    print(f"cli: corpus of {len(lengths)} videos ({', '.join(map(str, lengths))} frames), "
          f"index and seeded frame caches ready; Pillow {pil_note}")

    ckpt = {name: os.path.join(workdir, "cli", f"{name}.pth")
            for name in ("evp", "temporal", "refiner")}
    evp = MiTEVP(cfg, head_cfg, seed=SEED + 12, device=device)
    torch.save({k: v.cpu() for k, v in evp.state_dict().items()}, ckpt["evp"])
    f_dim = head_cfg.embedding_dim
    torch.save(MultiStageTCN(MSTCNConfig(f_dim=f_dim), seed=SEED + 13,
                             device="cpu").state_dict(), ckpt["temporal"])
    torch.save(RefinementTransformer(RefinerConfig(f_dim=f_dim), seed=SEED + 14,
                                     device="cpu").state_dict(), ckpt["refiner"])

    common = [*model_flags, "--batch-size", str(batch), "--device", device]
    run("extract-features", "--work", work, *common, "--pretrained-evp", ckpt["evp"],
        "--frame-cache", cache_root, "--reference-pickles")
    feature_fn = make_raw_feature_fn(evp)
    for split in splits:
        fc = caches[split]
        batches = (b[:3] for b in prefetch_batches(fc, np.arange(len(fc)), batch))
        want, _ = extract_features(feature_fn, batches, len(fc), f_dim, batch)
        store = FeatureStore.open(os.path.join(work, "lfb", split))
        got = np.asarray(store.features)
        pickled = FeatureStore.from_reference_pickle(
            os.path.join(work, "lfb", f"evp_LFB_{split}.pkl"), store.lengths,
            os.path.join(workdir, "cli", "from_pickle", split))
        if got.shape != (len(fc), f_dim) or not np.array_equal(got, want):
            raise AssertionError(f"{split}: the store differs from extract_features on its frames")
        if not np.array_equal(np.asarray(pickled.features), got):
            raise AssertionError(f"{split}: the reference pickle does not hold the store")
    print("cli: extract-features stores equal extract_features on the same frames, "
          "split by split; the reference pickles load")

    run("reference-parity", "--root", root, "--work", work, *common, "--evp", ckpt["evp"],
        "--temporal", ckpt["temporal"], "--refiner", ckpt["refiner"], "--num-videos",
        str(len(lengths)), "--scheme", "smoke", "--online")
    with open(os.path.join(work, "reference_parity.json")) as f:
        report = json.load(f)
    table = ("acc_frame", "acc_video", "inMAE", "pMAE", "eMAE", "relaxed_acc")
    values = [report[s][k] for s in ("val", "test") for k in table]
    agree = report["online_offline_agreement"]
    print("cli: reference-parity report: " + ", ".join(
        f"{s} {k} {report[s][k]:.4f}" for s in ("val", "test") for k in table)
        + f"; online/offline agreement {agree:.4f} (random weights: finiteness is checked)")
    if not np.isfinite(values).all() or agree < 0.999:
        raise AssertionError(f"reference-parity: metrics {values}, agreement {agree}")
    print("cli: seconds per verb: " + ", ".join(f"{v} {s:.3f}" for v, s in seconds.items()))
    return {"seconds": seconds, "agreement": agree}


def main() -> int:
    smi = phase_toolchain()
    phase_build()
    checks = phase_kernel_checks()
    n_hgmma = phase_sass()
    scan = phase_scan_checks()
    train_checks = phase_train_kernel_checks()
    with tempfile.TemporaryDirectory() as workdir:
        sl = phase_slice(workdir)
        tp = phase_temporal(workdir, sl)
        tr = phase_train(workdir)
        phase_extract_cli(workdir)
    blk, stg, pk = checks["block"], checks["stage"], checks["packed2"]
    blk_main, stg_main = checks["block_main"], checks["stage_main"]
    main_scan = [r for r in scan if r["shape"].startswith("[Bt=1,")]  # the test videos' shapes
    summed = lambda rows, key: sum(r[key] for r in rows)
    by = lambda rows: max(("bytes", "operations"),
                          key=lambda b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b))
    kernels = [
        {"name": "mit_block_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:236",
         "also_replaces": "surgical_tpu/kernels/mit_block.py:449",
         "launches": sl["launches"]["mit_block_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in blk),
         "ms": summed(blk, "ms"), "plain_ms": summed(blk, "plain_ms"),
         "bound_ms": summed(blk, "bound_ms"), "bound_by": by(blk), "library_ms": None,
         f"ms_b{BATCH}": summed(blk_main, "ms"), f"bound_ms_b{BATCH}": summed(blk_main, "bound_ms"),
         f"max_abs_err_b{BATCH}": max(r["max_abs_err"] for r in blk_main), "hgmma": n_hgmma,
         "shapes": blk + blk_main},
        {"name": "mit_block_packed2_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:801",
         "launches": sl["route_launches"]["mit_block_packed2_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in pk),
         "ms": pk[1]["ms"], "plain_ms": pk[1]["plain_ms"], "bound_ms": pk[1]["bound_ms"],
         "bound_by": pk[1]["bound_by"], "library_ms": None, "shapes": pk},
        {"name": "mit_stage_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:1202",
         "launches": sl["launches"]["mit_stage_forward"],
         "max_abs_err": stg["max_abs_err"], "ms": stg["ms"], "plain_ms": stg["plain_ms"],
         "bound_ms": stg["bound_ms"], "bound_by": stg["bound_by"], "library_ms": None,
         f"ms_b{BATCH}": stg_main["ms"], f"bound_ms_b{BATCH}": stg_main["bound_ms"],
         f"max_abs_err_b{BATCH}": stg_main["max_abs_err"], "hgmma": n_hgmma,
         "shapes": [stg, stg_main]},
        {"name": "selective_scan_forward", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": "surgical_tpu/kernels/selective_scan.py:130",
         "launches": tp["launches"],
         "max_abs_err": max(r["max_abs_err"] for r in scan),
         "ms": summed(main_scan, "ms"), "plain_ms": summed(main_scan, "plain_ms"),
         "bound_ms": summed(main_scan, "bound_ms"), "bound_by": by(main_scan),
         "library_ms": None, "shapes": scan},
    ]
    for name, line, key in (("mit_block_train_forward", 1645, "forward"),
                            ("mit_block_train_mlp_backward", 1695, "mlp_backward"),
                            ("mit_block_train_attn_backward", 1729, "attn_backward")):
        rows = train_checks[key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"surgical_tpu/kernels/mit_block.py:{line}",
            "launches": tr["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": summed(rows, "ms"), "plain_ms": summed(rows, "plain_ms"),
            "bound_ms": summed(rows, "bound_ms"), "bound_by": by(rows), "library_ms": None,
            "shapes": rows})
    banned = ("jax", "flax", "optax", "orbax", "surgical_tpu")
    if any(m.split(".")[0] in banned for m in sys.modules):
        raise AssertionError("the port's run imported JAX or the JAX package")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
