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
   library's SASS, which must exceed the serving products' own; the
   selective scan in fp32 (d_inner 128, d_state 64; 2000 and 6000 frames,
   3 ragged videos of 777, and the chunk edges: 1, 63 and 65 frames at its
   64-step chunks, and 200), with the device operations one call issues
   (at most 2); its backward kernel at the same shapes and T = 129 (six
   gradients against the plain backward, and up to T = 2000 against
   autograd through the plain forward; two runs equal bit for bit; timed
   at T = 2000 and 6000, at most 3 device operations per call); and the
   three kernels of the training block in bf16 at the
   four b3 stages (B=8 and the training batch B=88, DropPath factors with
   zeros; the plain versions timed at B=8), the attention backward run
   twice for dk and dv equal bit for bit and its device operations per call
   counted (at most 5, no memset); then each MiT kernel wrapper refusing
   an input that requires grad under grad mode, and the scan under grad
   returning a grad_fn whose backward launches the backward kernel;
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
6. temporal training at full width through ``cli.main``: separable
   synthetic 2048-d features (train videos of 2000, 4000 and 6000 frames),
   ``train-temporal`` for ``MambaConfig()`` and for ``MSTCNConfig()``, cut
   one epoch short and ``--resume``d, against the uninterrupted run
   (weights and optimizer state), 8 backward-kernel launches per Mamba
   step; ``train-refiner``; ``predict`` with the learned gate (frame
   accuracy >= 0.75 on the test txts) and ``evaluate``; the median train
   step at T = 2000 and 6000; ``selfcheck`` on the card;
7. backbone training: ``BackboneTrainer(use_fused=True)`` at b3, batch 88,
   224 crop, SGD, over a seeded ``FrameCache`` (3 train batches, one val and
   one test batch) for 2 epochs of ``train_epoch`` with mid-epoch
   validation, then ``evaluate``: 28 launches of each train kernel per step,
   step time, peak memory, a frozen trunk, moved trainable tensors and
   BatchNorm statistics, a checkpoint round trip with the optimizer state,
   and one step's loss and gradients against the plain train kernels;
8. flax-graph backbone at b3 widths (``MiTEVP.graph_forward``, plain
   PyTorch, no kernel): the default prompts, ``fft``, ``bimask`` and
   ``fully_unshared`` at B=8, 224 px, bf16 (finite), and at B=2 on the
   card in fp32 and in bf16 against the CPU's fp32; the per-frame feature
   cosine against the serving graph on the kernels (``fused_forward``) on
   the same weights at B=8; ``BackboneTrainer(use_fused=False)`` over the
   training phase's frame caches (batch 88, 2 epochs of 3 steps with
   mid-epoch validation, then ``evaluate``): step time, frames/s, peak
   memory, no launch of any MiT kernel, a frozen trunk, moved trainable
   tensors and BatchNorm statistics, a checkpoint round trip, and one
   step's trainable gradients against the fused trunk's with the same
   masks; then ``selfcheck --full --device cuda`` with its learned gates
   where Pillow is importable;
9. extraction CLI at b3 widths through ``cli.main`` on 250-px frames: a
   synthetic Cholec80-layout corpus of 4 videos, ``prepare-data --scheme
   smoke``, a seeded ``FrameCache`` per split (``cache-frames`` too where
   Pillow is importable), seeded models saved as reference ``.pth`` files,
   ``extract-features --pretrained-evp --frame-cache --reference-pickles``
   (each store against ``extract_features`` on the same frames, the pickles
   read back), ``reference-parity --online`` on those stores (finite
   metrics, online/offline agreement), and the seconds of each verb;
10. result: a JSON line of per-kernel numbers (the serving kernels' B=200
   and the train kernels' B=88 times and bounds beside the B=8 ones; the
   scan's backward at T = 2000 and 6000), the card line, and the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
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
# summation order (dk and dv summed over query rows in CTA and split order),
# which flips occasional bf16 roundings. {output: (rel L2 bound, max abs
# bound as a fraction of the plain output's max |.|)}: a few times the H100
# readings at the four stages (rel L2 at most 8.5e-4 y, 1.7e-4 x1, 3.3e-4
# dx, 2.7e-3 dxln, 2.3e-3 dk, 1.6e-3 dv; max abs at most 1.1e-2 of max
# |plain|).
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
# The flax-graph phase (phase_flax_graph): prompt variants at b3 widths, run
# at FG_B frames on the card and at FG_CPU_B against the CPU's fp32 graph.
FG_VARIANTS = {"default": {}, "fft": {"input_type": "fft"}, "bimask": {"input_type": "bimask"},
               "fully_unshared": {"adaptor": "fully_unshared"}}
FG_B, FG_CPU_B = 8, 2
# Bounds, a few times the H100 readings: rel L2 of the pooled features,
# card fp32 (TF32 off) vs CPU fp32, summation order only (read at most
# 6.1e-7), and card bf16 vs CPU fp32, bf16 roundings through 28 blocks (read
# at most 5.2e-3); the per-frame cosine of the flax graph's bf16 features
# against the serving graph's, whose blocks take the tanh GELU where the
# flax graph's take exact erf (read: min 0.999993); one step's trainable
# gradients, flax graph vs fused trunk with the same masks, rel L2 per group
# (read at most 7.2e-2: the GELU forms again, through 28 blocks).
FG_FP32_BOUND, FG_BF16_BOUND, FG_COS_BOUND, FG_GRAD_BOUND = 5e-6, 2e-2, 0.9999, 0.2
# Conv biases right before a train-mode BatchNorm: the batch mean removes
# them, so their gradient is zero up to rounding and they need not move.
BN_FED_BIASES = tuple(f"flow_encoder.conv{i}.bias" for i in (1, 2, 3, 4))

SOURCE = "surgical_tpu_torch/csrc/mit_block.cu"
# HGMMA instructions in the library when only the serving products ran on
# wgmma (cuobjdump -sass, CUDA 12.9, on the H100 machine)
SERVING_HGMMA = 84
SCAN_SOURCE = "surgical_tpu_torch/csrc/selective_scan.cu"
# Kernels of the first design that the redesigns retired: none may be left in
# the library's SASS (gemm_bf16 and attention_kernel served packed2 alone).
FIRST_DESIGN = ("gemm_bf16", "attention_kernel")

# Selective scan at MambaConfig() widths: (videos, frames) per check. The
# kernel cuts time into chunks (64 steps up to T = 2048, 192 at 6000):
# T = 1, 63 and 65 are one chunk, just under it and one step past it; 200 is
# the slice videos' length.
SCAN_D, SCAN_N = 128, 64
SCAN_SHAPES = ((1, 1), (1, 63), (1, 65), (1, 200), (1, 2000), (1, 6000), (3, 777))
SCAN_MAX_OPS, ATTN_BWD_MAX_OPS = 2, 5  # device operations per call, at most
# Kernel vs plain, both fp32 with expf: they differ by the summation order
# over N. A few times the H100 readings (rel L2 1.1e-7, max abs 7.6e-6 on
# outputs up to |y| ~ 46).
SCAN_BOUNDS = (1e-6, 5e-5)
# The backward: every SCAN_SHAPES entry and T = 129, held to the plain
# backward (and to autograd through the plain forward up to
# SCAN_AUTOGRAD_T), fp32 with TF32 off; timed at the Mamba videos' lengths.
# (rel L2 bound per gradient, max abs bound as a fraction of the oracle's
# max |.|): fp32 sums in other orders (over N in the warp, over channels per
# block and then over blocks, over chunks).
SCAN_BWD_SHAPES = SCAN_SHAPES[:3] + ((1, 129),) + SCAN_SHAPES[3:]
SCAN_AUTOGRAD_T, SCAN_BWD_TIMED, SCAN_BWD_MAX_OPS = 2000, (2000, 6000), 3
SCAN_BWD_BOUNDS = (1e-4, 1e-4)
SCAN_GRADS = ("x", "dt", "A", "B", "C", "D")
TEST_LENGTHS = (2000, 6000)        # the temporal slice's test videos (Cholec80 lengths)
# The extraction CLI phase's videos in 1-fps frames: the smoke split makes
# videos 1-2 train, 3 val and 4 test; ragged last batches at batch 200.
CLI_LENGTHS = (150, 120, 200, 230)
# Max abs logits, streaming vs offline Mamba + refiner on the val videos, both
# fp32: a few times the H100 reading (7.2e-7).
ONLINE_BOUND = 5e-6

# Temporal training at full width (phase_temporal_train): videos of
# Cholec80 lengths, features that separate the phases (after the JAX
# selfcheck's label + 0.1 x noise, see TT_SCALE), one video per step. Per
# model: (temporal epochs, temporal lr, refiner epochs, refiner lr); the
# refiner's are the JAX selfcheck --full's (15 at 5e-3), the temporal ones
# reach val accuracy above 0.9 on an H100 (PERF.md, PR 8). The learned gate
# is the JAX selfcheck --full's: frame accuracy of the predicted phase txts.
TT_TRAIN, TT_VAL, TT_TEST = (2000, 4000, 6000), (3000,), (2500, 5000)
# The label's scale in the features. At the selfcheck's scale (label + 0.1 x
# noise: up to 6 on every one of 2048 dims) the Mamba stack, which has no
# norm inside its residual blocks (as the reference's), grows each block's
# output faster than its input, and train-mode dropout's 1 / 0.9 tips it
# into overflow: its loss is NaN within 3 steps at lr 1e-4 to 3e-3, on the
# CPU's plain path as on the card (PERF.md, PR 8).
TT_SCALE = 0.1
TT_RECIPES = {"mamba": (12, 1e-3, 15, 5e-3), "mstcn": (30, 3e-3, 15, 5e-3)}
GATE = 0.75
# Resumed vs uninterrupted: weights and optimizer state after the last epoch,
# max abs difference (equal bits expected where every kernel of the step is
# deterministic; cuDNN's convolution backward in MS-TCN need not be).
RESUME_TOL = 1e-5

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


def scan_bwd_work(Bt, T, D, N):
    """(bytes, seconds of operations) of the scan's gradient: x, dt, dy read
    and dx, ddt written ([Bt, T, D] fp32), B, C read and dB, dC written
    ([Bt, T, N]), A, D read and dA, dD written; per (t, d, n) one exp (a_t)
    on the SFUs and 16 fp32 flops (the state, the adjoint, the products
    with B, C, A and the sums of dA, dB, dC)."""
    nbytes = 4 * (5 * Bt * T * D + 4 * Bt * T * N + 2 * (D * N + D))
    elems = Bt * T * D * N
    return nbytes, max(16 * elems / FP32_FLOPS, elems / SFU_OPS)


def device_ops(fn, tries: int = 3) -> list:
    """Names of the device operations (kernels, memsets, copies) one call of
    ``fn`` issues, from torch.profiler. Every kernel call issues at least
    one, so a trace with none was lost (seen once on an H100): the call is
    traced again, and a third empty trace raises."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    raise AssertionError(f"torch.profiler saw no device operation in {tries} traced calls")


def _op_name(name: str) -> str:
    """A device operation's name without namespace, template arguments and
    parameters: wgmma_linear, attention_bwd_tc_kernel."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0]


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
    block at stages 1-3, packed2 at stage 1 (beside the block kernel on the
    same inputs), the stage kernel at stage 4."""
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
    # the 56x56 grid) at CHECK_B, and at row_chunks 2 at the main path's
    # BATCH; the bound is the function's work, block_work's; the block
    # kernel (row 1) is timed on the same unpacked inputs
    C, side, Nkv, hidden = 64, 56, 49, 256
    N = side * side
    w = _block_weights(rng, C, hidden)
    packed = mb.pack_weights2(w)
    packed_rows = []
    for b, rcs in ((B, (1, 2)), (BATCH, (2,))):
        x, k, v = _rand(rng, (b, N, C)), _rand(rng, (b, Nkv, C)), _rand(rng, (b, Nkv, C))
        nbytes, flops = block_work(b, N, C, Nkv, hidden)
        bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
        block_ms = time_ms(lambda: mb.fused_mit_block(x, k, v, w, heads=1, H=side, W=side))
        unpacked = mb.fused_mit_block(x, k, v, w, heads=1, H=side, W=side)
        for rc in rcs:
            kw = dict(H=side, W=side, row_chunks=rc)
            got = mb.fused_mit_block_packed2(x, k, v, packed, **kw)
            want = mb.fused_mit_block_packed2_plain(x, k, v, packed, **kw)
            torch.cuda.synchronize()
            shape = f"stage1 [B={b}, N={N}, C={C}, Nkv={Nkv}, hidden={hidden}, row_chunks={rc}]"
            rel, mx = _compare(f"packed2 {shape}", got, want, 1)
            vs_block = _errors("packed2", got, unpacked)
            del got, want
            ms = time_ms(lambda: mb.fused_mit_block_packed2(x, k, v, packed, **kw))
            # the plain version repeats the kernel's arithmetic: timed at CHECK_B only
            plain_ms = (time_ms(lambda: mb.fused_mit_block_packed2_plain(x, k, v, packed, **kw))
                        if b == B else None)
            print(f"time packed2 B={b} rc={rc}: kernel {ms:.4f} ms plain "
                  f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
                  f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP) | mit_block_forward "
                  f"on the same unpacked inputs {block_ms:.4f} ms (outputs rel L2 "
                  f"{vs_block[0]:.3e}, max abs {vs_block[1]:.3e} apart)")
            packed_rows.append({"shape": shape, "B": b, "rel_l2": rel, "max_abs_err": mx,
                                "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                                "block_ms": block_ms})
        del x, k, v, unpacked
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
    the serving products and the training forward's and MLP backward's run
    on Hopper's warpgroup tensor-core path. The serving products alone
    compiled to SERVING_HGMMA of them; the training products' instances
    (the scaled-residual epilogue, the K-major GELU-gradient and fp32
    products) must add more. No kernel of the first design (FIRST_DESIGN)
    may be left; the scan kernels' registers and shared memory are printed
    from ``cuobjdump -res-usage``."""
    from surgical_tpu_torch.kernels import _build

    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.build())], capture_output=True,
                          text=True, check=True).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"sass: {n} HGMMA instructions in {os.path.relpath(_build.build())} (the serving "
          f"products alone: {SERVING_HGMMA})")
    if n <= SERVING_HGMMA:
        raise AssertionError("the training products added no HGMMA instruction to the library")
    functions = [ln.split("Function :", 1)[1].strip() for ln in sass.splitlines()
                 if "Function :" in ln]
    retired = [f for f in functions if any(r in f for r in FIRST_DESIGN)]
    print(f"sass: {len(functions)} kernels; first-design kernels left: {retired or 'none'}")
    if retired:
        raise AssertionError(f"the first design's kernels are still in the library: {retired}")
    res = subprocess.run([_cuobjdump(), "-res-usage", str(_build.build())], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    for i, line in enumerate(res):  # "Function <mangled>:" then "REG:.. STACK:.. SHARED:.."
        if "selective_scan" in line and i + 1 < len(res):
            print(f"sass: {line.strip()} {res[i + 1].strip()}")
    return n


def scan_inputs(rng, Bt, T, D=SCAN_D, N=SCAN_N):
    """fp32 scan inputs on the card with Mamba's ranges: dt through softplus,
    A = -exp(.) of the A_log init's size."""
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    dt = torch.nn.functional.softplus(f(Bt, T, D) - 3.0)
    A = -torch.exp(0.5 * f(D, N) + 1.0)
    return f(Bt, T, D), dt, A, f(Bt, T, N), f(Bt, T, N), f(D)


def phase_scan_checks() -> tuple[list, list]:
    """The scan's forward kernel, then its backward kernel, against their
    plain versions at SCAN_SHAPES and SCAN_BWD_SHAPES: the forward's output,
    the backward's six gradients (held to ``selective_scan_plain_backward``
    on the card, and where T <= SCAN_AUTOGRAD_T to torch autograd through
    ``selective_scan_plain`` too), two backward runs equal bit for bit, times,
    bounds and device operations per call."""
    from surgical_tpu_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(SEED + 5)
    rows, bwd_rows = [], []
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
        ops = device_ops(lambda: ss.selective_scan(*args))
        ms = time_ms(lambda: ss.selective_scan(*args))
        plain_ms = time_ms(lambda: ss.selective_scan_plain(*args), reps=3)
        nbytes, op_s = scan_work(Bt, T, SCAN_D, SCAN_N)
        bms, by = bound_ms(nbytes, op_s)
        print(f"time scan [Bt={Bt}, T={T}]: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{Bt * T * SCAN_D * SCAN_N / 1e6:.1f} M exp); chunk {ss.scan_chunk(T)}, "
              f"{len(ops)} device ops per call (at most {SCAN_MAX_OPS})")
        if len(ops) > SCAN_MAX_OPS:
            raise AssertionError(f"selective_scan: {len(ops)} device ops per call: {ops}")
        rows.append({"shape": f"[Bt={Bt}, T={T}, D={SCAN_D}, N={SCAN_N}]", "T": T, "rel_l2": rel,
                     "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "device_ops": len(ops)})
        del got, want
    failed = []
    usage = ss.backward_resources(SCAN_D)
    cl = -(-SCAN_D // ss.CLUSTER_WARPS)
    print(f"resources scan backward (cluster launch, D = {SCAN_D}): {usage['registers']} "
          f"registers, {usage['local_bytes']} spill bytes per thread, "
          f"{usage['static_smem']} + {usage['dynamic_smem']} bytes of shared memory, "
          f"{ss.CLUSTER_WARPS * 32} threads and {usage['ctas_per_sm']} CTA(s) per SM, "
          f"clusters of {cl}: {usage['active_clusters']} active at once")
    for Bt, T in SCAN_BWD_SHAPES:
        args = scan_inputs(rng, Bt, T)
        dy = torch.from_numpy(rng.standard_normal((Bt, T, SCAN_D)).astype(np.float32)).cuda()
        y_states, states = ss.selective_scan_forward(*args, states=True)
        if not torch.equal(y_states, ss.selective_scan_forward(*args)[0]):
            failed.append(f"forward with states differs from forward without {Bt}x{T}")
        got = ss.selective_scan_backward(*args, dy, states)
        again = ss.selective_scan_backward(*args, dy, states)
        oracles = {"plain": ss.selective_scan_plain_backward(*args, dy)}
        if T <= SCAN_AUTOGRAD_T:
            ins = [a.clone().requires_grad_() for a in args]
            oracles["autograd"] = torch.autograd.grad(ss.selective_scan_plain(*ins), ins, dy)
        torch.cuda.synchronize()
        shape = f"[Bt={Bt}, T={T}, D={SCAN_D}, N={SCAN_N}]"
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        worst_rel, worst_abs = 0.0, 0.0
        for oracle, want in oracles.items():
            for name, g, w in zip(SCAN_GRADS, got, want):
                if not w.any():  # dA at T = 1: h_0 = 0, so the gradient is exactly zero
                    rel, mx, scale = float(g.any()), g.abs().max().item(), 0.0
                else:
                    rel, mx, scale = _errors(f"scan d{name} {shape}", g, w)
                ok = rel <= SCAN_BWD_BOUNDS[0] and mx <= SCAN_BWD_BOUNDS[1] * scale
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, mx)
                print(f"check scan backward d{name} {shape} vs {oracle}: rel_l2 {rel:.3e} "
                      f"(bound {SCAN_BWD_BOUNDS[0]}) max_abs {mx:.3e} (bound "
                      f"{SCAN_BWD_BOUNDS[1]} x max|{oracle}| {scale:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"d{name} {shape} vs {oracle}")
        print(f"check scan backward {shape}: two runs equal bit for bit: {same}")
        if not same:
            failed.append(f"determinism {shape}")
        del oracles, again
        row = {"shape": shape, "T": T, "rel_l2": worst_rel, "max_abs_err": worst_abs}
        if T in SCAN_BWD_TIMED:
            call = lambda: ss.selective_scan_backward(*args, dy, states)
            ops = device_ops(call)
            fwd_ops = device_ops(lambda: ss.selective_scan_forward(*args, states=True))
            k2 = ss.backward_chunk(Bt, T, usage["active_clusters"])
            clusters = Bt * -(-T // (ss.SUB_CHUNK * k2))
            ctas, waves = clusters * cl, clusters / usage["active_clusters"]
            ms = time_ms(call)
            plain_ms = time_ms(lambda: ss.selective_scan_plain_backward(*args, dy), reps=3)
            nbytes, op_s = scan_bwd_work(Bt, T, SCAN_D, SCAN_N)
            bms, by = bound_ms(nbytes, op_s)
            scratch = 4 * ss.backward_scratch_floats(Bt, T, SCAN_D, SCAN_N, k2)
            state_bytes = 4 * int(np.prod(ss.states_shape(Bt, T, SCAN_D, SCAN_N)))
            print(f"time scan backward {shape}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
                  f"{Bt * T * SCAN_D * SCAN_N / 1e6:.1f} M exp); {len(ops)} device ops per call "
                  f"(at most {SCAN_BWD_MAX_OPS}): {', '.join(map(_op_name, ops))}; cluster "
                  f"launch: chunks of {k2} sub-chunks, {clusters} clusters, {ctas} CTAs, "
                  f"{waves:.2f} waves; scratch {scratch / 1e6:.2f} MB, the "
                  f"forward's states {state_bytes / 1e6:.2f} MB ({len(fwd_ops)} device ops "
                  f"for the forward with states)")
            if len(ops) > SCAN_BWD_MAX_OPS:
                failed.append(f"device ops {shape}: {ops}")
            if len(fwd_ops) > SCAN_MAX_OPS:
                failed.append(f"forward device ops with states {shape}: {fwd_ops}")
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, device_ops=len(ops),
                       sub_chunks=k2, ctas=ctas, waves=waves, scratch_bytes=scratch,
                       state_bytes=state_bytes)
        bwd_rows.append(row)
        del got, args, dy, states, y_states
    if failed:
        raise AssertionError(f"selective_scan_backward disagrees or varies: {failed}")
    return rows, {"shapes": bwd_rows, "resources": usage}


def phase_train_kernel_checks() -> dict:
    """The three kernels of fused_mit_block_train at the b3 training shapes
    (224x224, B = CHECK_B and the training batch TRAIN_B), each against its
    plain version on the same inputs: the forward's y and x1, and the
    backward's dx, dxln, dk, dv (the backward through both kernels and the
    plain LayerNorm-2 backward between them, against the whole plain
    backward, from the kernel's x1). Kernels timed at both batches, the plain
    versions at CHECK_B."""
    from surgical_tpu_torch.kernels import mit_block as mb

    rng = np.random.default_rng(SEED + 7)
    names = ("forward", "mlp_backward", "attn_backward")
    rows = {b: {k: [] for k in names} for b in (CHECK_B, TRAIN_B)}
    failed = []
    mb.reset_launches()
    for stage, C, heads, side, sr in TRAIN_STAGES:
        N, Nkv, hidden = side * side, (side // sr) ** 2, 4 * C
        w = _block_weights(rng, C, hidden)
        kw = dict(heads=heads, H=side, W=side)
        for B in (CHECK_B, TRAIN_B):
            x, xln = _rand(rng, (B, N, C)), _rand(rng, (B, N, C))
            k, v, dy = _rand(rng, (B, Nkv, C)), _rand(rng, (B, Nkv, C)), _rand(rng, (B, N, C))
            # DropPath factors at keep 0.9: some images dropped (0), the rest 1/keep
            keep = 0.9
            m1, m2 = (torch.from_numpy((rng.uniform(size=B) < keep) / keep).float().cuda()
                      for _ in range(2))
            m1[0], m2[1] = 0.0, 0.0
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
            del want_y, want_x1, want_grads

            # the MLP backward's inputs as the backward forms them
            h2ln = mb.layer_norm(x1, w["ln2_scale"], w["ln2_bias"])
            dmlp = (dy.float() * m2[:, None, None]).to(x.dtype)
            dx1 = grads[0]
            timed = {
                "forward": (lambda: mb.block_train_forward(x, xln, k, v, w, m1, m2, **kw),
                            lambda: mb.fused_mit_block_train_fwd_plain(x, xln, k, v, w, m1, m2,
                                                                       **kw),
                            ("y", "x1")),
                "mlp_backward": (
                    lambda: mb.block_train_mlp_backward(h2ln, dmlp, w, H=side, W=side),
                    lambda: mb._mlp_bwd_plain(h2ln, dmlp, w, H=side, W=side), ("dx",)),
                "attn_backward": (lambda: mb.block_train_attn_backward(xln, k, v, dx1, m1, w,
                                                                       heads=heads),
                                  lambda: mb._attn_bwd_plain(xln, k, v, dx1, m1, w, heads=heads),
                                  ("dxln", "dk", "dv")),
            }
            # the attention backward sums dk and dv in a fixed order, and
            # issues at most ATTN_BWD_MAX_OPS device operations, no memset
            runs = [mb.block_train_attn_backward(xln, k, v, dx1, m1, w, heads=heads)
                    for _ in range(2)]
            bits = lambda t: t.view(torch.int16)
            same = all(torch.equal(bits(a), bits(b)) for a, b in zip(runs[0][1:], runs[1][1:]))
            ops = device_ops(timed["attn_backward"][0])
            memsets = [n for n in ops if "memset" in n.lower()]
            print(f"check train attn_backward {shape}: dk, dv equal bit for bit over two runs: "
                  f"{same}; {len(ops)} device ops per call (at most {ATTN_BWD_MAX_OPS}, "
                  f"memsets {len(memsets)}): {', '.join(map(_op_name, ops))}")
            if not same:
                failed.append(f"attn_backward determinism {shape}")
            if len(ops) > ATTN_BWD_MAX_OPS or memsets:
                failed.append(f"attn_backward device ops {shape}: {ops}")
            del runs
            work = block_train_work(B, N, C, Nkv, hidden)
            for kname, (kern, plain, outs) in timed.items():
                ms = time_ms(kern)
                # the plain versions repeat the kernels' arithmetic: timed at CHECK_B only
                plain_ms = time_ms(plain) if B == CHECK_B else None
                nbytes, flops = work[kname]
                bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
                print(f"time train {kname} stage{stage} B={B}: kernel {ms:.4f} ms plain "
                      f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
                      f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
                rows[B][kname].append({
                    "shape": shape, "max_abs_err": max(errs[o][1] for o in outs),
                    "rel_l2": max(errs[o][0] for o in outs), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by})
            rows[B]["attn_backward"][-1]["device_ops"] = len(ops)
            del x, xln, k, v, dy, y, x1, grads, h2ln, dmlp, dx1, timed
    print(f"train kernel checks: launches block_train_forward {mb.block_train_forward.launches}, "
          f"block_train_mlp_backward {mb.block_train_mlp_backward.launches}, "
          f"block_train_attn_backward {mb.block_train_attn_backward.launches} "
          "(checks and timing only; not the main path's)")
    if failed:
        raise AssertionError(f"train kernels disagree with their plain versions: {failed}")
    return rows


def phase_grad_guard() -> None:
    """Each MiT kernel wrapper, given a CUDA input that requires grad while
    grad mode is on, raises before it launches (its output would carry no
    gradient); the same call under no_grad runs. The selective scan instead
    returns an output with a grad_fn under grad, and its backward launches
    the backward kernel."""
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.kernels import selective_scan as ss

    rng = np.random.default_rng(SEED + 10)
    B, side, C, heads, Nkv, hidden = 2, 8, 64, 1, 4, 256
    w = _block_weights(rng, C, hidden)
    sw = {key: t.reshape(1, 1, -1) if t.dim() == 1 else t[None]
          for key, t in w.items() if not key.startswith("ln")}
    sw.update(ln1=torch.stack([w["ln1_scale"], w["ln1_bias"]])[None],
              ln2=torch.stack([w["ln2_scale"], w["ln2_bias"]])[None],
              wkv=_rand(rng, (1, C, 2 * C), C ** -0.5), bkv=_rand(rng, (1, 1, 2 * C), 0.1))
    sw = {key: t.contiguous() for key, t in sw.items()}
    x = _rand(rng, (B, side * side, C)).requires_grad_()
    k, v, m = _rand(rng, (B, Nkv, C)), _rand(rng, (B, Nkv, C)), torch.ones(B, device="cuda")
    scan = scan_inputs(rng, 1, 64)
    kw = dict(heads=heads, H=side, W=side)
    calls = {
        "fused_mit_block": lambda: mb.fused_mit_block(x, k, v, w, **kw),
        "fused_mit_block_packed2": lambda: mb.fused_mit_block_packed2(
            x, k, v, mb.pack_weights2(w), H=side, W=side),
        "fused_mit_stage": lambda: mb.fused_mit_stage(x, None, sw, **kw, sr=1),
        "block_train_forward": lambda: mb.block_train_forward(x, x, k, v, w, m, m, **kw),
        "block_train_mlp_backward": lambda: mb.block_train_mlp_backward(x, x, w, H=side,
                                                                        W=side),
        "block_train_attn_backward": lambda: mb.block_train_attn_backward(x, k, v, x, m, w,
                                                                          heads=heads),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: ran under grad with an input that requires grad")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    print(f"guard: {len(calls)} kernel wrappers refuse an input that requires grad under grad "
          f"mode and run under no_grad: {', '.join(calls)}")
    ss.reset_launches()
    x = scan[0].requires_grad_()
    y = ss.selective_scan(x, *scan[1:])
    if y.grad_fn is None or ss.selective_scan.launches != 1:
        raise AssertionError("selective_scan under grad: no grad_fn or no forward launch")
    y.sum().backward()
    torch.cuda.synchronize()
    if ss.selective_scan_backward.launches != 1 or not torch.isfinite(x.grad).all():
        raise AssertionError("selective_scan: .backward() did not launch the backward kernel")
    print(f"guard: selective_scan under grad returns {type(y.grad_fn).__name__}, "
          f"1 forward launch, and .backward() launches selective_scan_backward once")


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
    print(f"train: evaluate on {TRAIN_B} test frames (flax graph, eval mode): acc {ev['acc']:.4f} "
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
            "peak_gib": peak_gib, "grad_cos": cos, "loss_rel": loss_rel, "caches": caches}


def _rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _mit_launches() -> dict:
    from surgical_tpu_torch.kernels import mit_block as mb

    return {k.__name__: k.launches for k in (
        mb.fused_mit_block, mb.fused_mit_block_packed2, mb.fused_mit_stage,
        mb.block_train_forward, mb.block_train_mlp_backward, mb.block_train_attn_backward)}


def phase_flax_graph(workdir: str, caches: dict, cfg=None, head_cfg=None, device: str = "cuda",
                     train_b: int = TRAIN_B, selfcheck: bool = True) -> dict:
    """The flax module graph at b3 widths (defaults BackboneConfig(),
    HeadConfig()): prompt variants on the card against the CPU, features
    against the serving graph on the kernels, BackboneTrainer(use_fused=False)
    over the training phase's frame caches with zero MiT-kernel launches, its
    gradients against the fused trunk's, then selfcheck --full. Every line
    it prints is asserted."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, OptimConfig, TrainConfig
    from surgical_tpu_torch.core.rng import generator
    from surgical_tpu_torch.data.datasets import ClipSampler, clip_start_indices, prefetch_batches
    from surgical_tpu_torch.data.transforms import draw_params
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mit_fused import fused_forward
    from surgical_tpu_torch.models.mit_train import draw_masks
    from surgical_tpu_torch.train.backbone import BackboneTrainer, is_trainable

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    rng = np.random.default_rng(SEED + 10)
    size = cfg.img_size
    inputs = [torch.from_numpy(rng.standard_normal((FG_B, size, size, c)).astype(np.float32))
              for c in (3, 3, 2)]
    small = [t[:FG_CPU_B] for t in inputs]
    on_dev = lambda ts: [t.to(dev) for t in ts]
    res = {"variants": {}}

    # (a) the variants: finite at FG_B in bf16; at FG_CPU_B against the CPU
    tf32 = torch.backends.cudnn.allow_tf32
    for name, kw in FG_VARIANTS.items():
        vcfg = dataclasses.replace(cfg, **kw)
        cpu_model = MiTEVP(vcfg, head_cfg, seed=SEED + 11, device="cpu")
        if vcfg.input_type == "bimask":  # a non-zero positional embedding
            with torch.no_grad():
                cpu_model.prompt_generator.bimask_pos_embed.normal_(
                    0.0, 0.1, generator=torch.Generator().manual_seed(SEED + 12))
        model = copy.deepcopy(cpu_model).to(dev)
        with torch.no_grad():
            feats = model.graph_forward(*on_dev(inputs), return_features=True,
                                        dtype=torch.bfloat16)
            want = cpu_model.graph_forward(*small, return_features=True)
            torch.backends.cudnn.allow_tf32 = False
            try:
                got32 = model.graph_forward(*on_dev(small), return_features=True)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            got16 = model.graph_forward(*on_dev(small), return_features=True,
                                        dtype=torch.bfloat16)
        finite = bool(torch.isfinite(feats).all()) and feats.shape == (FG_B, head_cfg.embedding_dim)
        e32, e16 = _rel_l2(got32, want), _rel_l2(got16.float(), want)
        ok = finite and e32 <= FG_FP32_BOUND and e16 <= FG_BF16_BOUND
        print(f"flax: variant {name}: B={FG_B} bf16 features {tuple(feats.shape)} "
              f"{'finite' if finite else 'NOT FINITE'}; B={FG_CPU_B} vs CPU fp32: rel L2 card fp32 "
              f"{e32:.3e} (bound {FG_FP32_BOUND}), card bf16 {e16:.3e} (bound {FG_BF16_BOUND}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flax graph variant {name} disagrees with the CPU")
        res["variants"][name] = {"rel_l2_fp32": e32, "rel_l2_bf16": e16}
        if name == "default":
            # (b) the same weights through the serving graph on the kernels
            with torch.no_grad():
                served = fused_forward(model, *on_dev(inputs))
            cos = torch.nn.functional.cosine_similarity(feats.float(), served.float(), dim=1)
            res["cosine_min"] = float(cos.min())
            print(f"flax: flax graph vs serving graph (fused_forward, kernels) on the same "
                  f"weights, B={FG_B}: per-frame feature cosine min {res['cosine_min']:.6f} "
                  f"mean {float(cos.mean()):.6f} (bound {FG_COS_BOUND})")
            if res["cosine_min"] < FG_COS_BOUND:
                raise AssertionError("the flax graph disagrees with the serving graph")
        del model, cpu_model

    # (c) training on the flax graph
    model = MiTEVP(cfg, head_cfg, seed=SEED, device=dev)
    tcfg = TrainConfig(optim=OptimConfig(name="sgd", lr=1e-3, weight_decay=0.0,
                                         grad_clip_norm=None))
    n_batches = len(caches["train"]) // train_b
    trainer = BackboneTrainer(model, tcfg, val_every=n_batches, use_fused=False)
    opt = trainer.init()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = lambda name, idx: prefetch_batches(caches[name], idx, train_b)
    n_train = len(caches["train"])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mb.reset_launches()
    epochs, step_ms = [], []
    for epoch in range(TRAIN_EPOCHS):
        idx = ClipSampler(1, clip_start_indices(1, [n_train])).indices(epoch=epoch, shuffle=True)
        epochs.append(trainer.train_epoch(batches("train", idx), epoch,
                                          val_batches=list(batches("val", np.arange(train_b)))))
        step_ms += trainer.step_ms
    sync()
    launches = _mit_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    med = float(np.median(step_ms[1:]))  # the first step is the warm-up
    print("flax: train step ms " + ", ".join(f"{v:.2f}" for v in step_ms)
          + f"; median after warm-up {med:.3f} ms = {train_b / med * 1e3:.1f} frames/s; "
          f"peak memory {peak_gib:.2f} GiB (batch {train_b})")
    for e, tm in enumerate(epochs):
        print(f"flax: epoch {e}: loss {tm['train_loss']:.4f} acc {tm['train_acc']:.4f}")
    print(f"flax: MiT kernel launches during the flax-graph steps, mid-epoch validation "
          f"included: {launches} (expected all 0)")
    if any(launches.values()) or not all(np.isfinite(tm["train_loss"]) for tm in epochs):
        raise AssertionError("the flax graph launched a MiT kernel, or its loss is not finite")
    after = model.state_dict()
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    trunk_moved = [k for k in moved if not is_trainable(k)]
    still = sorted(trainable - moved - set(BN_FED_BIASES))
    bn_keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    bn_moved = [k for k in bn_keys if k in moved]
    print(f"flax: {len(trainable & moved)} of {len(trainable)} trainable tensors moved; trunk "
          f"tensors moved: {len(trunk_moved)}; BatchNorm statistics moved: {len(bn_moved)} of "
          f"{len(bn_keys)}")
    if trunk_moved or still or len(bn_moved) != len(bn_keys):
        raise AssertionError(f"trunk moved {trunk_moved[:5]}, trainable still {still[:5]}")
    ev = trainer.evaluate(batches("test", np.arange(train_b)), num_each=[train_b])
    print(f"flax: evaluate on {train_b} test frames: acc {ev['acc']:.4f} (finite metrics)")
    if not all(np.isfinite(ev[k]) for k in ("acc", "precision_macro", "recall_macro")):
        raise AssertionError(f"evaluate: metrics not finite: {ev}")

    store = CheckpointStore(os.path.join(workdir, "ckpt", "backbone_flax"))
    store.save(TRAIN_EPOCHS - 1, model.state_dict(), metrics={"val_acc": ev["acc"]},
               aux={"optimizer": opt.state_dict()})
    model2 = MiTEVP(cfg, head_cfg, seed=SEED + 9, device=dev)
    opt2 = BackboneTrainer(model2, tcfg).init()
    store.restore(TRAIN_EPOCHS - 1, model2, dev)
    opt2.load_state_dict(store.restore_aux(TRAIN_EPOCHS - 1)["optimizer"])
    same_model = all(torch.equal(model2.state_dict()[k], v) for k, v in model.state_dict().items())
    st1, st2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    same_opt = st1.keys() == st2.keys() and all(
        torch.equal(st1[i]["momentum_buffer"], st2[i]["momentum_buffer"]) for i in st1)
    print(f"flax: checkpoint round trip: model {'equal' if same_model else 'DIFFERS'}, "
          f"optimizer state ({len(st1)} momentum buffers) {'equal' if same_opt else 'DIFFERS'}")
    if not (same_model and same_opt):
        raise AssertionError("the flax-graph checkpoint does not round-trip")
    del model2, opt2

    # one batch, the same augmentation and masks, flax graph vs fused trunk
    img, seg, flow, labels, ant = caches["train"].frames(np.arange(train_b))
    ap = draw_params(generator(SEED, 0, purpose="augment", device=dev), trainer.aug_cfg, train_b)
    masks = draw_masks(cfg, head_cfg, train_b, generator(SEED, 0, purpose="droppath", device=dev))

    def grads(tr):
        out, _ = tr.loss_and_grad(img, seg, flow, labels, ant, aug_params=ap, masks=masks)
        groups = {}
        for n, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault(n.split(".")[0], []).append(p.grad.flatten())
        return out["loss"].item(), {g: torch.cat(v) for g, v in groups.items()}

    loss_g, g_g = grads(trainer)
    fused = BackboneTrainer(model, tcfg, use_fused=True)
    fused.init()
    loss_f, g_f = grads(fused)
    model.zero_grad(set_to_none=True)
    rel = {g: _rel_l2(g_g[g], g_f[g]) for g in g_g}
    print(f"flax: one step, flax graph vs fused trunk, same masks: loss {loss_g:.5f} vs "
          f"{loss_f:.5f}; gradient rel L2 per group " + ", ".join(f"{g} {v:.3e}" for g, v in
                                                                  rel.items())
          + f" (bound {FG_GRAD_BOUND})")
    if max(rel.values()) > FG_GRAD_BOUND:
        raise AssertionError("the flax graph's gradients disagree with the fused trunk's")
    res.update({"step_ms": med, "fps": train_b / med * 1e3, "peak_gib": peak_gib,
                "launches": launches, "grad_rel_l2": rel})
    del model, trainer, fused, opt

    # (d) the whole pipeline from synthetic images
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("flax: selfcheck --full not run: Pillow is not importable on this machine (its "
              "corpus writer saves JPEGs)")
        return res
    if not selfcheck:
        return res
    t0 = time.perf_counter()
    rc = cli.main(["selfcheck", "--full", "--device", device])
    res["selfcheck_s"] = time.perf_counter() - t0
    print(f"flax: selfcheck --full --device {device}: rc {rc} in {res['selfcheck_s']:.1f} s "
          "(Pillow importable)")
    if rc != 0:
        raise AssertionError("selfcheck --full failed")
    return res


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
          f"{predict_s:.3f} s; selective_scan launches {launches} (expected {want}), "
          f"selective_scan_backward launches {ss.selective_scan_backward.launches} (expected 0)")
    if launches != want or ss.selective_scan_backward.launches:
        raise AssertionError("the Mamba serving path did not launch the scan kernel 8 times per "
                             "video, or launched its backward")
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


def _separable_split(work, split, lengths, ids, rng):
    """A split of whole videos whose 2048-d features separate the phases, as
    the JAX selfcheck makes them (label + 0.1 x noise) but with the label
    centred and scaled, (label - 3) x TT_SCALE: the 7 phases in order, each
    over a random share of the video."""
    from surgical_tpu_torch.data.feature_store import FeatureStore

    labels = []
    for L in lengths:
        cuts = np.sort(rng.choice(np.arange(1, L), 6, replace=False))
        labels.append(np.repeat(np.arange(7), np.diff(np.concatenate([[0], cuts, [L]]))))
    labels = np.concatenate(labels)
    feats = ((labels[:, None] - 3) * TT_SCALE
             + 0.1 * rng.standard_normal((len(labels), 2048))).astype(np.float32)
    FeatureStore.create(os.path.join(work, "lfb", split), feats, lengths, meta={"split": split})
    _index_split(work, split, labels, lengths, ids, rng)
    return labels


def _store_diff(a: str, b: str, step: int) -> tuple[float, bool]:
    """(max abs difference, equal bit for bit) of two stores' weights and
    optimizer state at ``step``."""
    from surgical_tpu_torch.core.checkpoint import CheckpointStore

    sa, sb = CheckpointStore(a), CheckpointStore(b)
    load = lambda st: torch.load(st._path(step, ".pt"), weights_only=True)
    flat = lambda st: [v for s in st.restore_aux(step)["optimizer"]["state"].values()
                       for v in s.values() if isinstance(v, torch.Tensor)]
    pairs = list(zip(load(sa).values(), load(sb).values())) + list(zip(flat(sa), flat(sb)))
    worst = max((x.float() - y.float()).abs().max().item() for x, y in pairs)
    return worst, all(torch.equal(x, y) for x, y in pairs)


def _train_and_resume(run, root, data, gt_dir, ids, labels, steps, device) -> dict:
    """phase_temporal_train's per-model part: train-temporal cut one epoch
    short and resumed against the uninterrupted run, train-refiner, predict
    with the learned gate, evaluate."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.eval.predictions import read_phase_txt, video_txt_name
    from surgical_tpu_torch.kernels import selective_scan as ss

    out = {}
    for kind, (epochs, lr, r_epochs, r_lr) in TT_RECIPES.items():
        works = {}
        for name in ("resumed", "straight"):
            works[name] = os.path.join(root, f"{kind}_{name}")
            os.makedirs(works[name])
            for sub in ("index", "lfb"):
                os.symlink(os.path.join(data, sub), os.path.join(works[name], sub))
        flags = ["--model", kind, "--lr", str(lr)]
        ss.reset_launches()
        run("train-temporal", works["resumed"], *flags, "--epochs", str(epochs - 1))
        first = ss.selective_scan_backward.launches
        ss.reset_launches()
        run("train-temporal", works["resumed"], *flags, "--epochs", str(epochs), "--resume")
        resumed = ss.selective_scan_backward.launches
        # the main path: every count at 0 just before, read just after
        ss.reset_launches()
        run("train-temporal", works["straight"], *flags, "--epochs", str(epochs))
        launches = {"selective_scan_forward": ss.selective_scan.launches,
                    "selective_scan_backward": ss.selective_scan_backward.launches}
        layers = 8 if kind == "mamba" and device == "cuda" else 0
        want = [layers * steps * (epochs - 1), layers * steps, layers * steps * epochs]
        print(f"temporal train {kind}: train-temporal {epochs - 1} epochs, --resume to {epochs}, "
              f"and {epochs} uninterrupted at lr {lr}: selective_scan_backward launches "
              f"{first} / {resumed} / {launches['selective_scan_backward']} (expected "
              f"{' / '.join(map(str, want))}: {layers} per step), selective_scan forward "
              f"launches in the uninterrupted run {launches['selective_scan_forward']}")
        if [first, resumed, launches["selective_scan_backward"]] != want:
            raise AssertionError(f"{kind}: the backward kernel did not run {layers} times a step")
        tdirs = [os.path.join(works[n], "ckpt", "temporal") for n in ("resumed", "straight")]
        diff, same = _store_diff(*tdirs, epochs - 1)
        print(f"temporal train {kind}: resumed vs uninterrupted at epoch {epochs - 1}: weights "
              f"and optimizer state max abs diff {diff:.3e} (bound {RESUME_TOL}), bit for bit: "
              f"{same}")
        if not diff <= RESUME_TOL:
            raise AssertionError(f"{kind}: the resumed run does not continue the schedule")
        work = works["straight"]
        run("train-refiner", work, "--model", kind, "--lr", str(r_lr), "--epochs", str(r_epochs))
        ss.reset_launches()
        run("predict", work, "--model", kind, "--split", "test")
        fwd, bwd = ss.selective_scan.launches, ss.selective_scan_backward.launches
        if (fwd, bwd) != (layers * len(TT_TEST), 0):
            raise AssertionError(f"{kind} predict: scan launches {fwd} forward, {bwd} backward")
        pred = np.concatenate([read_phase_txt(os.path.join(work, "output", "Test",
                                                           video_txt_name(v)))
                               for v in ids["test"]])
        acc = float(np.mean(pred == labels["test"]))
        print(f"temporal train {kind}: predict on {len(TT_TEST)} test videos after "
              f"{r_epochs} refiner epochs at lr {r_lr}: frame accuracy of the phase txts "
              f"{acc:.4f} (gate {GATE}); scan launches {fwd} forward, {bwd} backward")
        if not acc >= GATE:
            raise AssertionError(f"{kind}: the trained pipeline did not learn separable phases")
        if cli.main(["evaluate", "--gt", gt_dir, "--pred", os.path.join(work, "output", "Test"),
                     "--first", str(ids["test"][0]), "--last", str(ids["test"][-1])]) != 0:
            raise AssertionError("cli evaluate failed")
        out[kind] = {"launches": launches, "resume_max_abs": diff, "resume_bitwise": same,
                     "acc": acc}
    return out


def phase_temporal_train(workdir: str, device: str = "cuda") -> dict:
    """Temporal and refiner training at full width through ``cli.main``:
    ``MambaConfig()`` (the scan's forward and backward kernels) and
    ``MSTCNConfig()``, each ``RefinerConfig(f_dim=2048)``, on separable
    synthetic features (TT_TRAIN train videos, TT_VAL val, TT_TEST test).
    Per model: ``train-temporal`` for its epochs less one, ``--resume`` to
    its epochs, against the uninterrupted run (weights and optimizer state);
    ``train-refiner``; ``predict`` on test (the learned gate on the phase
    txts: frame accuracy >= GATE) and ``evaluate``. Then the median train
    step at T = 2000 and 6000 (Mamba) and 6000 (MS-TCN), and ``selfcheck``
    on the card. The uninterrupted Mamba run is the main path of the scan's
    backward kernel: its launches are read just after it. ``device`` and the
    TT_* lengths size the phase down for a rehearsal on the CPU."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.config import TrainConfig
    from surgical_tpu_torch.eval.predictions import video_txt_name, write_phase_txt
    from surgical_tpu_torch.kernels import selective_scan as ss
    from surgical_tpu_torch.train.temporal import TemporalTrainer, dropout_masks

    rng = np.random.default_rng(SEED + 15)
    root = os.path.join(workdir, "temporal_train")
    data, gt_dir = os.path.join(root, "data"), os.path.join(root, "gt")
    ids = {"train": [1, 2, 3], "val": [4], "test": [5, 6]}
    lengths = {"train": TT_TRAIN, "val": TT_VAL, "test": TT_TEST}
    labels = {split: _separable_split(data, split, lengths[split], ids[split], rng)
              for split in ("train", "val", "test")}
    starts = np.cumsum((0,) + TT_TEST[:-1])
    for vid, s0, L in zip(ids["test"], starts, TT_TEST):
        write_phase_txt(os.path.join(gt_dir, video_txt_name(vid)), labels["test"][s0:s0 + L])
    seconds = {}

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def run(verb, work, *args):
        t = time.perf_counter()
        if cli.main([verb, "--work", work, *args, "--device", device]) != 0:
            raise AssertionError(f"cli {verb} {' '.join(args)} failed")
        sync()
        seconds[f"{verb} {args[1]}"] = seconds.get(f"{verb} {args[1]}", 0.0) + (
            time.perf_counter() - t)

    steps = len(TT_TRAIN)  # one video per step
    # cuDNN's default convolution backward (MS-TCN's) sums with atomics: two
    # uninterrupted 30-epoch runs then differ (a max abs of 3e-2 in weights
    # on an H100). Its deterministic algorithms make the resume check exact.
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = _train_and_resume(run, root, data, gt_dir, ids, labels, steps, device)
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic

    # the train step alone, at full width
    step_ms = {}
    for kind, T in (("mamba", TT_TRAIN[0]), ("mamba", TT_TRAIN[-1]), ("mstcn", TT_TRAIN[-1])):
        model = cli._temporal_model(kind, device, 2048, seed=SEED)
        trainer = TemporalTrainer(model, TrainConfig())
        opt = trainer.init()
        lab = torch.from_numpy(np.sort(rng.integers(0, 7, (1, T)))).to(device)
        feats = lab[..., None].float() + 0.1 * torch.randn(1, T, 2048, device=device)
        ant = torch.rand(1, T, 7, device=device)
        mask = torch.ones(1, T, dtype=torch.bool, device=device)
        step = lambda: trainer.train_step(opt, feats, lab, ant, mask,
                                          dropout_masks(SEED, 0, 0, device))
        ss.reset_launches()
        step()
        per_step = ss.selective_scan_backward.launches
        if per_step != (8 if kind == "mamba" and device == "cuda" else 0):
            raise AssertionError(f"{kind} train step: {per_step} backward-kernel launches")
        step_ms[f"{kind} T={T}"] = median_ms(step) if device == "cuda" else None
        print(f"temporal train: {kind} train step at T = {T} (full width, one video): median "
              f"{step_ms[f'{kind} T={T}']} ms of 5; selective_scan_backward launches per step "
              f"{per_step}")
        del model, trainer, opt, feats
    t = time.perf_counter()
    if cli.main(["selfcheck", "--device", device]) != 0:
        raise AssertionError("cli selfcheck failed on the card")
    seconds["selfcheck"] = time.perf_counter() - t
    print("temporal train: seconds per verb: "
          + ", ".join(f"{v} {x:.3f}" for v, x in seconds.items()))
    return {**out, "step_ms": step_ms, "seconds": seconds}


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
    scan, scan_bwd = phase_scan_checks()
    train_checks = phase_train_kernel_checks()
    phase_grad_guard()
    with tempfile.TemporaryDirectory() as workdir:
        sl = phase_slice(workdir)
        tp = phase_temporal(workdir, sl)
        tt = phase_temporal_train(workdir)
        tr = phase_train(workdir)
        phase_flax_graph(workdir, tr["caches"])
        phase_extract_cli(workdir)
    blk, stg, pk = checks["block"], checks["stage"], checks["packed2"]
    blk_main, stg_main = checks["block_main"], checks["stage_main"]
    main_scan = [r for r in scan if r["shape"].startswith("[Bt=1,") and r["T"] in TEST_LENGTHS]
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
         "bound_by": pk[1]["bound_by"], "library_ms": None,
         f"ms_b{BATCH}": pk[-1]["ms"], f"bound_ms_b{BATCH}": pk[-1]["bound_ms"],
         f"block_ms_b{BATCH}": pk[-1]["block_ms"], "block_ms": pk[1]["block_ms"], "shapes": pk},
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
         "library_ms": None, "device_ops_per_call": max(r["device_ops"] for r in scan),
         "shapes": scan},
    ]
    bwd_main = [r for r in scan_bwd["shapes"] if "ms" in r]
    kernels.append({
        "name": "selective_scan_backward", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": "surgical_tpu/kernels/selective_scan.py:62 (jax.grad of the XLA scan; "
                    "no TPU kernel)",
        "launches": tt["mamba"]["launches"]["selective_scan_backward"],
        "max_abs_err": max(r["max_abs_err"] for r in scan_bwd["shapes"]),
        "ms": summed(bwd_main, "ms"), "plain_ms": summed(bwd_main, "plain_ms"),
        "bound_ms": summed(bwd_main, "bound_ms"), "bound_by": by(bwd_main), "library_ms": None,
        "device_ops_per_call": max(r["device_ops"] for r in bwd_main),
        "step_ms": tt["step_ms"], "resources": scan_bwd["resources"],
        "shapes": scan_bwd["shapes"]})
    for name, line, key in (("mit_block_train_forward", 1645, "forward"),
                            ("mit_block_train_mlp_backward", 1695, "mlp_backward"),
                            ("mit_block_train_attn_backward", 1729, "attn_backward")):
        rows, rows_main = train_checks[CHECK_B][key], train_checks[TRAIN_B][key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"surgical_tpu/kernels/mit_block.py:{line}",
            "launches": tr["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": summed(rows, "ms"), "plain_ms": summed(rows, "plain_ms"),
            "bound_ms": summed(rows, "bound_ms"), "bound_by": by(rows), "library_ms": None,
            f"ms_b{TRAIN_B}": summed(rows_main, "ms"),
            f"bound_ms_b{TRAIN_B}": summed(rows_main, "bound_ms"),
            f"max_abs_err_b{TRAIN_B}": max(r["max_abs_err"] for r in rows_main),
            "shapes": rows + rows_main})
        if key == "attn_backward":
            kernels[-1]["device_ops_per_call"] = max(r["device_ops"] for r in rows + rows_main)
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
