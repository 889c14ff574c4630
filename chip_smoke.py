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
   time; the block kernel at the streaming session's shapes, B=1 at all
   four b3 stages and stage 4 at B=8, both versions timed), then the count of HGMMA (wgmma) instructions in the built
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
5. streaming session: ``OnlineSession`` with the seeded b3 backbone (with
   flow) over 64 wire frames at 224 px, once with MS-TCN + refiner and once
   with Mamba alone: 28 block launches and no stage launch per frame, the
   features equal to offline extraction at batch 1 and the logits within
   1e-4 of the offline temporal (+ refiner) composition, the features'
   cosine against offline extraction at B=8 (the stage kernel), ms per
   frame split into the feature and temporal legs with each leg's device
   operations, and the refusal of a frame without flow;
6. temporal serving slice: seeded random Mamba (``MambaConfig()``) and
   refiner weights saved through ``CheckpointStore`` into a work dir whose
   ``val`` split is the extraction slice's three videos and whose ``test``
   split is two videos of 2000 and 6000 frames of random features; then
   ``cli predict --model mamba`` on test (8 scan launches per video),
   ``cli predict --model mamba --online`` on val, online vs offline logits,
   ``cli evaluate``, and Mamba + refiner latency per video;
7. temporal training at full width through ``cli.main``: separable
   synthetic 2048-d features (train videos of 2000, 4000 and 6000 frames),
   ``train-temporal`` for ``MambaConfig()`` and for ``MSTCNConfig()``, cut
   one epoch short and ``--resume``d, against the uninterrupted run
   (weights and optimizer state), 8 backward-kernel launches per Mamba
   step; ``train-refiner``; ``predict`` with the learned gate (frame
   accuracy >= 0.75 on the test txts) and ``evaluate``; the median train
   step at T = 2000 and 6000; ``selfcheck`` on the card;
8. backbone training: ``BackboneTrainer(use_fused=True)`` at b3, batch 88,
   224 crop, SGD, over a seeded ``FrameCache`` (3 train batches, one val and
   one test batch) for 2 epochs of ``train_epoch`` with mid-epoch
   validation, then ``evaluate``: 28 launches of each train kernel per step,
   step time, peak memory, a frozen trunk, moved trainable tensors and
   BatchNorm statistics, a checkpoint round trip with the optimizer state,
   and one step's loss and gradients against the plain train kernels;
9. flax-graph backbone at b3 widths (``MiTEVP.graph_forward``, plain
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
10. RAFT: a seeded upstream-layout ``.pth`` loaded strictly, two 250-px
   frames padded to 256: the card's fp32 flow at 20 iterations against the
   CPU's, the dense lookup against the gather oracle on the card, pairs per
   second; then ``cli precompute-flow`` over 2 synthetic videos of 6 JPEGs:
   each file against the flow_fn of its pair, a rerun that writes nothing, a
   corrupt JPEG that fails one pair and no other;
11. extraction CLI at b3 widths through ``cli.main`` on 250-px frames: a
   synthetic Cholec80-layout corpus of 4 videos, ``prepare-data --scheme
   smoke``, a seeded ``FrameCache`` per split (where Pillow is importable,
   ``precompute-flow`` over the val split's JPEGs and ``cache-frames``,
   whose cache must carry that flow), seeded models saved as reference ``.pth`` files,
   ``extract-features --pretrained-evp --frame-cache --reference-pickles``
   (each store against ``extract_features`` on the same frames, the pickles
   read back), ``reference-parity --online`` on those stores (finite
   metrics, online/offline agreement), and the seconds of each verb;
12. deployment export at b3 widths with flow on 224-px frames: ``cli
   export-serving`` of a seeded ``.pth`` (the flax graph and ``--fused``, at
   B=200 and B=1) and the streaming MS-TCN and refiner steps exported beside
   them; each backbone artifact run in a fresh process that imports torch
   (and ``kernels.ops`` for a fused one) and no model code, its outputs
   equal to the eager graph's bit for bit, the fused B=200 artifact
   launching the block kernel 25 times and the stage kernel once; 64 frames
   streamed through the three artifacts equal to ``OnlineSession`` bit for
   bit with 28 block launches per frame; export seconds, artifact bytes,
   load seconds, ms per call and per frame beside the eager graphs', and
   one custom-op dispatch's host cost against the bare launch;
13. int8 weights at b3, B=200: the extraction path with bf16 and with
   int8 weights on the same frames: int8 features equal the graph on the
   dequantized weights bit for bit, 25 block and 1 stage launch per batch,
   the held bytes, scripts/probe_int8.py's drift metrics under the JAX
   package's test gates, frames/s of each (median of 3, in turns) and the
   dequantization's device ms per batch;
14. result: printed after phase 15, a JSON line of per-kernel numbers (the serving kernels' B=200
   and the train kernels' B=88 times and bounds beside the B=8 ones; the
   scan's backward at T = 2000 and 6000; the block kernel's B=1 rows and its
   launches in the session; the serving kernels' launches through the ops
   in the export and int8 phases) with the session's ms per frame and
   launches per frame and RAFT's pairs per second beside them, the card
   line, and the last line
   ``{"ok": true, "device": {...}}``;
15. multi-rank (``surgical_tpu_torch/parallel/``): ranks spawned on cuda:0
   over gloo (one card per rank over NCCL where there are enough cards):
   the backend takes CUDA tensors in each collective; ``sp_mstcn_infer``
   and ``sp_mamba_infer`` at ``MSTCNConfig()`` / ``MambaConfig()``, T = 6000
   over 2 ranks, against the one-rank model (fp32, TF32 off; 1e-5 and 2e-4,
   8 scan launches per rank), and MS-TCN at T = 256 over 4 ranks (a halo
   over several chunks); data-parallel extraction of 208 frames bit for bit
   against one rank on each shard (25 block-wrapper launches, stages 1-3,
   and 1 stage launch per rank);
   the batch-sharded b3 step against the one-rank step, fp32 on the flax
   graph at batch 8 (rel L2 1e-5) and bf16 on the fused train kernels at
   batch 88 (5e-2, 28 launches of each per rank, the ranks' states equal);
   with two cards a block kernel and a scan launched on cuda:1 from current
   device 0; ``extract-features`` under ``torch.distributed.run`` on phase
   11's corpus at batch 200 against one process at batch 100, store by
   store bit for bit, 28 block-wrapper launches (stage 4 block by block at
   100 frames) and no stage launch per rank per batch;
   seconds per leg. The result line gains the launches per rank;
16. completion (``phase_completion``), the modules the port took last: the
   native frame decoder (whether it built, and the reason where not;
   ``ClipDataset.frames`` over 64 JPEG frames and segmaps of 250 px,
   frames/s on the route that runs beside the host CPU and the card; where
   the decoder built, two runs equal bit for bit, the difference from PIL
   and both routes' frames/s);
   ``capture_attention`` at b3, B=2, 224 px on the card against the CPU
   (28 maps, rel L2 1e-5); ``DualTowerMSTCN`` and ``HiddenFeatureMSTCN``
   at ``MSTCNConfig()`` on a 2000-frame video and ``Adaptor`` in both
   modes (max abs 1e-5); ``resize_bilinear`` (250 -> 224, 200 -> 250) and
   ``rotate`` (bit for bit); ``cli evaluate --vis`` on phase 6's txts where
   matplotlib imports. The result line gains its numbers;
17. widths (``phase_widths``), what the JAX package runs beyond b3 and
   ``MambaConfig()``: the block kernel at MiT-b0's stages 1-3 and the stage
   kernel at its stage 4 (head width 32) at B=8 and 200 against their plain
   versions, a 200-frame b0 extraction batch on the kernels (6 block and 1
   stage launch) against the plain serving graph, the b0 ``OnlineSession``
   (8 block launches per frame); the scan's forward and backward at the
   (d_state, d_inner) of ``WIDTH_SCAN`` (2000 frames) against the plain
   versions, with their launches; a refiner whose LayerNorms and FFN biases
   are away from identity and zero, card against CPU and streamed against
   offline. The kernel line's serving rows gain ``head_dims`` and a ``b0``
   block, the scan's rows ``widths``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import json
import os
import re
import shutil
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
# (read at most 7.2e-2: bf16 rounding, each graph's bf16 gradient lying
# 7-8e-2 from its own fp32 one at b3; in fp32 the two graphs differ by
# 6e-3 to 1.2e-2, the blocks' GELU forms).
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

# The streaming session (phase_online_session): b3 at 224 px, one frame per
# step through OnlineSession, SESSION_FRAMES frames through each of two
# sessions (MS-TCN + refiner, then Mamba alone); SESSION_BLOCKS block
# launches and no stage launch per frame (stage 4 block by block at B = 1).
SESSION_FRAMES, SESSION_BLOCKS = 64, 28
# Session logits against the offline composition on offline extraction at
# batch 1 (the same features, bit for bit): fp32 on both sides, summed in
# other orders (streaming steps vs cuDNN / the scan kernel); JAX's own bound
# (tests/test_online.py; H100 reading at most 1.0e-6).
SESSION_LOGIT_BOUND = 1e-4
# Per-frame feature cosine, the session's features against offline
# extraction at B = CHECK_B, where stage 4 runs the stage kernel (tanh prompt
# GELU in the kernel) and not the block kernel (exact erf): 1 - cosine at
# most a few times the H100 reading (min cosine 0.9999954).
SESSION_COS_BOUND = 0.99998

# The export phase (phase_export): b3 with flow on 224-px wire frames; a
# flax and a fused artifact through ``cli export-serving`` at B = BATCH and at
# 1, each run in a fresh process that imports torch (and kernels.ops for a
# fused one) and nothing of the model code, EXPORT_REPS timed calls; the
# stream of SESSION_FRAMES frames through the fused B = 1 backbone, MS-TCN
# step and refiner step artifacts. Each artifact's outputs equal the eager
# graph's bit for bit: the same ops, kernels and weights.
EXPORT_REPS = 5
# The int8 phase (phase_int8): INT8_BATCHES batches of BATCH frames with bf16
# and with int8 weights, extraction timed over INT8_RUNS runs in turns; the
# int8 features against the bf16 ones under the JAX package's own gates
# (tests/test_quant.py: median relative delta, correlation).
INT8_BATCHES, INT8_RUNS = 3, 3
INT8_MEDIAN_REL, INT8_CORR = 0.2, 0.95

# RAFT (phase_raft): upstream's 20 iterations on 250-px frames padded to 256
# (a 32x32 feature grid, levels 32 / 16 / 8 / 4); two synthetic videos of
# RAFT_VIDEO_FRAMES 1-fps frames for precompute-flow. Card fp32 (TF32 off)
# against the port's CPU fp32 on the same weights: rel L2 of the flow and
# the largest end-point error (px), a few times the H100 readings (1.6e-7
# and 2.9e-6 px on flows up to 6.8 px: summation order through 20
# iterations):
RAFT_SIZE, RAFT_ITERS, RAFT_VIDEO_FRAMES, RAFT_TIMED = 250, 20, 6, 10
RAFT_REL_BOUND, RAFT_EPE_BOUND = 1e-6, 1e-5
# Dense tent-weight lookup against the gather oracle on the card, max abs
# error over the largest |sample| (fp32, other summation order; the JAX
# test's bound, H100 reading 1.3e-7):
RAFT_LOOKUP_BOUND = 1e-5

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

# The multi-rank phase (phase_multirank): DP_RANKS ranks that all sit on
# cuda:0 over gloo (NCCL refuses two ranks on one card), or one card per
# rank over NCCL where the machine has as many. Time-sharded MS-TCN and
# Mamba (MSTCNConfig(), MambaConfig(), T = DP_T) against the one-rank model
# on the card, fp32 with TF32 off, max abs at JAX's bounds
# (__graft_entry__.py:182-184, :202-204); MS-TCN again at DP_HOP_T frames
# over DP_HOP_RANKS ranks, where the last layer's 256-frame halo spans four
# chunks. Extraction of a DP_EXTRACT_B-frame batch (104 frames per rank:
# 25 block + 1 stage launch per rank) bit for bit against one rank on each
# shard. The batch-sharded b3 step against the one-rank step on the same
# frames and draws: in fp32 on the flax graph at DP_STEP_FP32_B frames, rel
# L2 of the trainable gradients, the BatchNorm statistics and the parameters
# after one SGD step (the sharded sums add in another order); in bf16 with
# the fused train kernels at TRAIN_B frames, loss and gradients in rel L2
# (44 frames per rank round where 88 do; the bound of FG_GRAD_BOUND's kind),
# the ranks' states after the step equal bit for bit. Then the extraction
# CLI under torch.distributed.run on phase 11's corpus at BATCH against one
# process at BATCH / DP_RANKS (each rank's shard is that run's batch: 28
# block launches and no stage launch per rank per batch).
DP_RANKS, DP_T, DP_HOP_T, DP_HOP_RANKS = 2, 6000, 256, 4
DP_EXTRACT_B, DP_STEP_FP32_B = 208, 8
DP_MSTCN_BOUND, DP_MAMBA_BOUND = 1e-5, 2e-4
DP_FP32_BOUND, DP_BF16_BOUND = 1e-5, 5e-2

# Phase 16 (phase_completion): the native decoder over DECODE_FRAMES JPEG
# frames (and segmaps) of DECODE_SIDE px, the wire size; the card against
# the CPU in fp32 with TF32 off: capture_attention's maps at b3 in rel L2,
# the temporal classes (MSTCNConfig(), a COMPLETION_FRAMES-frame video) and
# resize_bilinear in max abs; rotate bit for bit.
DECODE_FRAMES, DECODE_SIDE, COMPLETION_FRAMES = 64, 250, 2000
COMPLETION_ATTN_BOUND, COMPLETION_ABS_BOUND = 1e-5, 1e-5

# Phase 17 (phase_widths): the widths beyond MiT-b3 and MambaConfig() that
# the JAX package runs. MiT-b0 (BackboneConfig.preset("b0"): widths 32 / 64 /
# 160 / 256 over 1 / 2 / 5 / 8 heads, head width 32 at every stage, depth 2
# per stage) at 224 px: (stage, C, heads, grid side, sr) of the block
# kernel's stages and stage 4's (C, heads, side, depth, Cb, C4) for the stage
# kernel; a BATCH-frame extraction batch takes 2 block launches at each of
# stages 1-3 and one stage launch, a streamed frame 8 block launches.
B0_STAGES = ((1, 32, 1, 56, 8), (2, 64, 2, 28, 4), (3, 160, 5, 14, 2))
B0_STAGE4 = (256, 8, 7, 2, 64, 64)
B0_BATCH_LAUNCHES = {"mit_block_forward": 6, "mit_stage_forward": 1}
B0_SESSION_FRAMES, B0_SESSION_BLOCKS = 8, 8
# The scan at these (d_state, d_inner): padded to the 32-state build (8, 16),
# the 64-state build as MambaConfig() (64), the 128-state build (128: the
# backward as two launches on its halves), one channel group (32 to 128
# channels) and two (256: d_model 128); WIDTH_SCAN_T frames, one video.
WIDTH_SCAN = ((8, 32), (16, 128), (16, 256), (64, 256), (64, 128), (128, 64))
WIDTH_SCAN_T = 2000
# A refiner (RefinerConfig(f_dim=2048)) whose LayerNorm scales and biases and
# FFN biases are moved from identity and zero by 0.2 x normal draws: the
# card against the CPU over a REFINER_T-frame video and the streaming step
# against the offline refiner over its first REFINER_STREAM_T frames, both
# fp32 within SESSION_LOGIT_BOUND.
REFINER_T, REFINER_STREAM_T = 2000, 300
REFINER_LN_BIAS = ("layernorm.weight", "layernorm.bias", "fc.0.bias", "fc.2.bias")

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


def device_busy(fn) -> tuple[float, int]:
    """(ms the device spent in the operations of one call of ``fn``, their
    number), from torch.profiler: the sum of the kernels', copies' and
    memsets' durations, without the host's issue time between them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3, len(evs)


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


def _block_check(rng, w, stage, heads, side, sr, b, plain: bool, bound_stage=None,
                 tag: str = "") -> dict:
    """The block kernel at one shape (random x, k, v of batch ``b``) against
    its plain version within ``BOUNDS[bound_stage or stage]``; the kernel
    timed, the plain version too with ``plain``; the bound of the work."""
    from surgical_tpu_torch.kernels import mit_block as mb

    C, hidden = w["wq"].shape[0], w["w1"].shape[1]
    N, Nkv = side * side, (side // sr) ** 2
    kw = dict(heads=heads, H=side, W=side)
    x, k, v = _rand(rng, (b, N, C)), _rand(rng, (b, Nkv, C)), _rand(rng, (b, Nkv, C))
    got = mb.fused_mit_block(x, k, v, w, **kw)
    want = mb.fused_mit_block_plain(x, k, v, w, **kw)
    torch.cuda.synchronize()
    shape = f"{tag}stage{stage} [B={b}, N={N}, C={C}, heads={heads}, Nkv={Nkv}]"
    rel, mx = _compare(f"block {shape}", got, want, bound_stage or stage)
    del got, want
    ms = time_ms(lambda: mb.fused_mit_block(x, k, v, w, **kw))
    plain_ms = time_ms(lambda: mb.fused_mit_block_plain(x, k, v, w, **kw)) if plain else None
    nbytes, flops = block_work(b, N, C, Nkv, hidden)
    bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
    print(f"time block {tag}stage{stage} B={b}: kernel {ms:.4f} ms plain "
          f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {"shape": shape, "B": b, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def _stage_weights(rng, C, depth, Cb, C4):
    """Random stage weights in ``stage_weights_from_params``' layout, with the
    in-kernel prompt (lww, lwb, sharedw, sharedb) at sr = 1."""
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
    return {k: t.contiguous() for k, t in sw.items()}


def _stage_check(rng, sw, heads, side, b, plain: bool, tag: str = "") -> dict:
    """The stage kernel (stage 4, sr = 1, with the prompt base) at batch ``b``
    against its plain version within ``BOUNDS[4]``, timed as
    ``_block_check``."""
    from surgical_tpu_torch.kernels import mit_block as mb

    depth, C = sw["wq"].shape[:2]
    Cb, C4 = sw["lww"].shape[1:]
    N = side * side
    kw = dict(heads=heads, H=side, W=side, sr=1)
    x, base = _rand(rng, (b, N, C)), _rand(rng, (b, N, Cb))
    got = mb.fused_mit_stage(x, base, sw, **kw)
    want = mb.fused_mit_stage_plain(x, base, sw, **kw)
    torch.cuda.synchronize()
    shape = f"{tag}stage4 [B={b}, N={N}, C={C}, heads={heads}, depth={depth}, base]"
    rel, mx = _compare(shape, got, want, 4)
    del got, want
    ms = time_ms(lambda: mb.fused_mit_stage(x, base, sw, **kw))
    plain_ms = time_ms(lambda: mb.fused_mit_stage_plain(x, base, sw, **kw)) if plain else None
    nbytes, flops = stage_work(b, N, C, 4 * C, depth, Cb, C4)
    bms, by = bound_ms(nbytes, flops / BF16_FLOPS)
    print(f"time {tag}stage4 B={b}: kernel {ms:.4f} ms plain "
          f"{'-' if plain_ms is None else f'{plain_ms:.4f}'} ms bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    return {"shape": shape, "B": b, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_kernel_checks() -> dict:
    """The serving kernels at B = CHECK_B (checked, timed, the plain version
    timed too) and at the main path's B = BATCH (checked and timed): the
    block at stages 1-3, packed2 at stage 1 (beside the block kernel on the
    same inputs), the stage kernel at stage 4; then the block at the
    streaming session's shapes (B = 1 at stages 1-4, stage 4 at CHECK_B),
    both versions timed."""
    from surgical_tpu_torch.kernels import mit_block as mb

    rng = np.random.default_rng(SEED)
    B, res = CHECK_B, {}
    block_rows, block_rows_main = [], []
    # (stage, C, heads, grid, sr): b3 at 224x224; Nkv = 49 at every stage
    for stage, C, heads, side, sr in ((1, 64, 1, 56, 8), (2, 128, 2, 28, 4), (3, 320, 5, 14, 2)):
        w = _block_weights(rng, C, 4 * C)
        for b, rows in ((B, block_rows), (BATCH, block_rows_main)):
            # the plain version repeats the kernel's arithmetic: timed at CHECK_B only
            rows.append(_block_check(rng, w, stage, heads, side, sr, b, plain=b == B))
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
    sw = _stage_weights(rng, C, depth, Cb, C4)
    res["stage"], res["stage_main"] = (_stage_check(rng, sw, heads, side, b, plain=b == B)
                                       for b in (B, BATCH))

    # the streaming session's shapes (phase_online_session): the block at
    # B = 1 on every b3 stage, stage 4 block by block (49 rows: under one
    # 128-row product tile and one 64-row attention tile; C = 512, the
    # widest resident panel and LayerNorm prologue; fc2 at K = 2048 streams
    # A), and stage 4's block at B = CHECK_B. Stage 4's block takes stage
    # 3's bounds (BOUNDS[4] is the stage kernel's); both versions timed.
    session_rows = []
    for stage, C, heads, side, sr in TRAIN_STAGES:
        w = _block_weights(rng, C, 4 * C)
        for b in ((1, B) if stage == 4 else (1,)):
            session_rows.append(_block_check(rng, w, stage, heads, side, sr, b, plain=True,
                                             bound_stage=min(stage, 3)))
    res["block_session"] = session_rows
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


def phase_online_session(device: str = "cuda", cfg=None, head_cfg=None, size: int = 224,
                         frames: int = SESSION_FRAMES, batch: int = CHECK_B,
                         blocks: int = SESSION_BLOCKS) -> dict:
    """The frame-in / phase-out streaming session at b3 widths
    (``BackboneConfig()`` with flow, ``HeadConfig()``): seeded models, wire
    frames (u8 frames and segmaps, f16 flow) through ``OnlineSession.step``
    one at a time, with ``MSTCNConfig()`` + ``RefinerConfig(f_dim=2048)`` and
    then with ``MambaConfig()`` alone. Per session: the launches of the
    counted run (``SESSION_BLOCKS`` block launches, no stage launch per
    frame); a second pass that times the feature leg and the temporal (+
    refiner) leg apart and gives the same logits; the features equal to
    offline extraction at batch 1 (``extract_features``) and the logits
    within ``SESSION_LOGIT_BOUND`` of the offline temporal (+ refiner)
    composition on them; the features' cosine against offline extraction
    at ``batch`` (the stage kernel's route) and the argmax agreement of the
    logits there; the device operations of each leg; then the refusal of a
    frame without flow. ``cfg``, ``head_cfg``, ``size`` and ``device`` size
    it down for a rehearsal on the CPU, where nothing is timed or counted;
    ``cfg`` and ``blocks`` (block launches per frame: the backbone's depth)
    run it at another MiT size on the card."""
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MambaConfig,
                                                MSTCNConfig, RefinerConfig)
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mamba import CausalMambaModel
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN, OnlineRefiner,
                                                   OnlineSession)
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn
    from surgical_tpu_torch.train.refiner import predict_video

    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    f_dim = head_cfg.embedding_dim
    t0 = time.perf_counter()
    backbone = MiTEVP(cfg, head_cfg, seed=SEED + 20, device=device)
    mstcn = MultiStageTCN(MSTCNConfig(f_dim=f_dim), seed=SEED + 21, device=device)
    refiner = RefinementTransformer(RefinerConfig(f_dim=f_dim), seed=SEED + 22, device=device)
    mamba = CausalMambaModel(MambaConfig(f_dim=f_dim), seed=SEED + 23, device=device)
    rng = np.random.default_rng(SEED + 20)
    wire = (rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (frames, size, size, 1), dtype=np.uint8),
            rng.standard_normal((frames, size, size, 2), dtype=np.float32).astype(np.float16))
    frame = lambda t: tuple(a[t] for a in wire)

    # offline extraction of the same frames, at batch 1 (the session's route)
    # and at `batch` (stage 4 on the stage kernel at a multiple of 8)
    feature_fn = make_raw_feature_fn(backbone)
    feats1, _ = extract_features(feature_fn, (tuple(a[t:t + 1] for a in wire)
                                              for t in range(frames)), frames, f_dim, 1)
    feats_b, _ = extract_features(feature_fn, (tuple(a[i:i + batch] for a in wire)
                                               for i in range(0, frames, batch)),
                                  frames, f_dim, batch)
    print(f"session: {cfg.variant} models + {frames} wire frames at {size} px, offline "
          f"extraction at batch 1 and {batch}, in {time.perf_counter() - t0:.2f} s")

    res = {}
    for name, temporal, ref in (("mstcn+refiner", OnlineMSTCN(mstcn), OnlineRefiner(refiner)),
                                ("mamba", OnlineMamba(mamba), None)):
        session = OnlineSession(backbone, temporal, refiner=ref)
        session.step(*frame(0))  # warm-up of the temporal leg's shapes
        session.reset()
        sync()
        mb.reset_launches()
        outs, step_ms = [], []
        for t in range(frames):
            t1 = time.perf_counter()
            outs.append(session.step(*frame(t)))
            step_ms.append((time.perf_counter() - t1) * 1e3)
        launches = {"mit_block_forward": mb.fused_mit_block.launches,
                    "mit_stage_forward": mb.fused_mit_stage.launches}
        want = {"mit_block_forward": blocks * frames, "mit_stage_forward": 0}
        print(f"session {name}: launches over {frames} frames {launches} (expected {want})")
        if cuda and launches != want:
            raise AssertionError("the session did not launch the block kernel as expected")
        outs = np.stack(outs)

        # the two legs timed apart on a second pass over the same frames
        session.reset()
        feat_ms, leg_ms, feats, again = [], [], [], []
        for t in range(frames):
            sync()
            t1 = time.perf_counter()
            f = session.features(*frame(t))
            sync()
            t2 = time.perf_counter()
            again.append(session.advance(f).cpu().numpy())
            feat_ms.append((t2 - t1) * 1e3)
            leg_ms.append((time.perf_counter() - t2) * 1e3)
            feats.append(f.cpu().numpy())
        feats = np.stack(feats)
        if not np.array_equal(np.stack(again), outs):
            raise AssertionError(f"session {name}: a second pass gave other logits")
        if feats.shape != (frames, f_dim) or not np.array_equal(feats, feats1):
            raise AssertionError(f"session {name}: features differ from offline extraction at "
                                 f"batch 1 (max abs {np.abs(feats - feats1).max():.3e})")
        with torch.no_grad():
            offline = lambda lfb: (predict_video(mstcn, refiner, lfb) if ref is not None
                                   else mamba(lfb[None])[-1, 0]).cpu().numpy()
            off1 = offline(torch.tensor(feats1, device=device))
            off_b = offline(torch.tensor(feats_b, device=device))
        err = float(np.abs(outs - off1).max())
        cos = torch.nn.functional.cosine_similarity(torch.tensor(feats), torch.tensor(feats_b),
                                                    dim=-1).numpy()
        agree = float((outs[:, :7].argmax(-1) == off_b[:, :7].argmax(-1)).mean())
        print(f"session {name}: features equal offline extraction at batch 1; logits vs the "
              f"offline composition max abs {err:.3e} (bound {SESSION_LOGIT_BOUND}); features vs "
              f"offline at batch {batch}: cosine min {cos.min():.7f} median "
              f"{np.median(cos):.7f} (bound {SESSION_COS_BOUND}); phase argmax agreement "
              f"there {agree:.4f} (information)")
        if not np.isfinite(outs).all() or err > SESSION_LOGIT_BOUND:
            raise AssertionError(f"session {name}: logits disagree with the offline pipeline")
        if cos.min() < SESSION_COS_BOUND:
            raise AssertionError(f"session {name}: features disagree with the stage route")
        row = {"ms_per_frame": float(np.median(step_ms)),
               "feature_ms": float(np.median(feat_ms)), "temporal_ms": float(np.median(leg_ms)),
               "launches": launches, "logit_err": err, "cos_min": float(cos.min()),
               "argmax_agreement": agree}
        if cuda:
            f0 = session.features(*frame(0))
            row["device_ops"] = {"features": len(device_ops(lambda: session.features(*frame(0)))),
                                 "temporal": len(device_ops(lambda: session.advance(f0)))}
            print(f"time session {name}: median ms per frame {row['ms_per_frame']:.3f} "
                  f"(features {row['feature_ms']:.3f}, temporal leg {row['temporal_ms']:.3f}; "
                  f"step range {min(step_ms):.3f}-{max(step_ms):.3f}); device operations per "
                  f"frame {row['device_ops']}")
        res[name] = row

    img, seg, _ = frame(0)
    try:
        session.step(img, seg, None)
    except ValueError as e:
        print(f"session: a frame without flow is refused: {str(e)[:60]}...")
    else:
        raise AssertionError("a flow-trained backbone served a frame without flow")
    return res


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


def _raft_frames(rng, size: int, n: int) -> np.ndarray:
    """``n`` uint8 frames [size, size, 3] of one smooth texture moving by
    (2, 3) px per frame (bilinear upsampling of coarse noise)."""
    pad = 3 * n + 8
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, (size + pad) // 8 + 2,
                                                   (size + pad) // 8 + 2)).astype(np.float32))
    canvas = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear")
    canvas = canvas[0].permute(1, 2, 0).clamp(0, 255).round().to(torch.uint8).numpy()
    return np.stack([canvas[2 * i:2 * i + size, 3 * i:3 * i + size] for i in range(n)])


def _flow_files(root: str) -> dict:
    out = {}
    flow_root = os.path.join(root, "raft_flow_npy")
    for v in sorted(os.listdir(flow_root)):
        for f in sorted(os.listdir(os.path.join(flow_root, v)), key=lambda s: int(s[:-4])):
            out[f"{v}/{f}"] = np.load(os.path.join(flow_root, v, f))
    return out


def _flow_log(root: str) -> tuple[dict, str]:
    """(the stats of the log's last ``video <v>: {stats}`` line, the log)."""
    with open(os.path.join(root, "flow_precompute_log.txt")) as f:
        text = f.read()
    return ast.literal_eval(re.findall(r"video \S+: (\{.*\})$", text, re.M)[-1]), text


def phase_raft(workdir: str, device: str = "cuda", size: int = RAFT_SIZE,
               iters: int = RAFT_ITERS, video_frames: int = RAFT_VIDEO_FRAMES) -> dict:
    """RAFT and ``cli precompute-flow``: a seeded upstream-layout state dict
    (cnet BatchNorm statistics away from identity) saved as a ``.pth`` with
    the DataParallel prefix and loaded strictly on the card; one pair of
    ``size``-px frames padded to a multiple of 8: the card's fp32 flow
    (TF32 off) against the port's CPU fp32 on the same weights at ``iters``
    iterations, the dense lookup against the gather oracle on the card at
    the pair's feature grid, pairs per second and the device operations of
    one pair; then ``precompute-flow`` through ``cli.main`` over a
    Cholec80-layout corpus of 2 videos x ``video_frames`` JPEGs at stride
    25: every file equal to the flow_fn of its pair, a rerun that writes
    nothing, and a corrupt JPEG that fails its one pair (a logged
    traceback) while every other pair is written."""
    from PIL import Image

    from surgical_tpu_torch import cli
    from surgical_tpu_torch.data.datasets import load_image
    from surgical_tpu_torch.flow.precompute import FlowPrecomputeDriver, pad_to_multiple_hw
    from surgical_tpu_torch.models import raft as R
    from surgical_tpu_torch.models.convert import load_torch_pth

    cuda = device == "cuda"
    rng = np.random.default_rng(SEED + 30)
    d = os.path.join(workdir, "raft")
    os.makedirs(d, exist_ok=True)
    cpu_model = R.RAFT(iters=iters, seed=SEED + 30, device="cpu")
    with torch.no_grad():
        for m in cpu_model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
    pth = os.path.join(d, "raft-things.pth")
    torch.save({f"module.{k}": v for k, v in cpu_model.state_dict().items()}, pth)
    card = R.RAFT(iters=iters, device=device)
    card.load_state_dict(load_torch_pth(pth), strict=True)

    f1, f2 = _raft_frames(rng, size, 2).astype(np.float32)
    p1, _ = pad_to_multiple_hw(f1)
    p2, _ = pad_to_multiple_hw(f2)
    flow_fn = R.make_flow_fn(card)
    t0 = time.perf_counter()
    got = flow_fn(p1, p2)
    first_s = time.perf_counter() - t0
    want = R.make_flow_fn(cpu_model)(p1, p2)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    epe = float(np.sqrt(((got - want) ** 2).sum(-1)).max())
    print(f"raft: {iters} iterations on {size}-px frames padded to {p1.shape[0]}: card vs CPU "
          f"fp32 flow rel L2 {rel:.3e} (bound {RAFT_REL_BOUND}), max end-point error {epe:.3e} px "
          f"(bound {RAFT_EPE_BOUND}); |flow| up to {np.abs(want).max():.3f} px; first call "
          f"{first_s:.2f} s")
    if got.shape != p1.shape[:2] + (2,) or not np.isfinite(got).all():
        raise AssertionError(f"raft: flow of shape {got.shape}, finite {np.isfinite(got).all()}")
    if rel > RAFT_REL_BOUND or epe > RAFT_EPE_BOUND:
        raise AssertionError("raft: the card's flow disagrees with the CPU's")

    # the dense lookup against the gather oracle on the pair's feature grid
    with torch.no_grad(), R.fp32_precision():
        x = (torch.from_numpy(np.stack([p1, p2])).to(device) / 127.5 - 1.0).permute(0, 3, 1, 2)
        fa, fb = card.fnet(x.contiguous())
        pyr = R.corr_pyramid(R.all_pairs_correlation(fa, fb), card.corr_levels)
        grid = tuple(fa.shape[1:])
        lookup_err = 0.0
        for scale in (0.0, 0.5, 3.7, 30.0):
            flow = torch.from_numpy((scale * rng.standard_normal((2, *grid))).astype(np.float32))
            flow = flow.to(device)
            dense = R.lookup_pyramid(pyr, flow, card.corr_radius)
            oracle = R.lookup_pyramid_gather(pyr, flow, card.corr_radius)
            lookup_err = max(lookup_err, ((dense - oracle).abs().max()
                                          / oracle.abs().max()).item())
        timing = ""
        if cuda:
            dense_ms = time_ms(lambda: R.lookup_pyramid(pyr, flow, card.corr_radius))
            gather_ms = time_ms(lambda: R.lookup_pyramid_gather(pyr, flow, card.corr_radius))
            timing = f"; one lookup {dense_ms:.4f} ms dense, {gather_ms:.4f} ms gather"
    print(f"raft: dense lookup vs gather at the {grid[0]}x{grid[1]} grid, {len(pyr)} levels: max "
          f"abs error over max |sample| {lookup_err:.3e} (bound {RAFT_LOOKUP_BOUND}){timing}")
    if lookup_err > RAFT_LOOKUP_BOUND:
        raise AssertionError("raft: the dense lookup disagrees with the gather oracle")
    out = {"iters": iters, "size": [size, size], "padded": list(p1.shape[:2]), "rel_l2": rel,
           "max_epe": epe, "lookup_err": lookup_err}
    if cuda:
        ms = median_ms(lambda: flow_fn(p1, p2), runs=RAFT_TIMED)
        a = torch.from_numpy(p1).to(device) / 127.5 - 1.0
        b = torch.from_numpy(p2).to(device) / 127.5 - 1.0
        ops = len(device_ops(lambda: card(a, b)))
        out.update(ms_per_pair=ms, pairs_per_s=1e3 / ms, device_ops_per_pair=ops)
        print(f"time raft: {ms:.3f} ms per pair = {1e3 / ms:.2f} pairs/s (host clock, median of "
              f"{RAFT_TIMED}, frames from and flow to the host); {ops} device operations per "
              f"pair ({ops / iters:.1f} per iteration and the encoders)")

    # precompute-flow through the CLI over a synthetic corpus
    root = os.path.join(d, "cholec80")
    for v in (1, 2):
        vdir = os.path.join(root, "cutMargin", str(v))
        os.makedirs(vdir, exist_ok=True)
        for i, img in enumerate(_raft_frames(rng, size, video_frames)):
            Image.fromarray(img).save(os.path.join(vdir, f"{25 * i}.jpg"))
    args = ["precompute-flow", "--iters", str(iters), "--torch-checkpoint", pth,
            "--device", device]
    seconds = {}

    def run(name, at):
        t = time.perf_counter()
        if cli.main([*args, "--root", at]) != 0:
            raise AssertionError(f"cli precompute-flow ({name}) failed")
        seconds[name] = time.perf_counter() - t
        return _flow_files(at), _flow_log(at)

    pairs = 2 * (video_frames - 1)
    files, (stats, _) = run("first", root)
    driver = FlowPrecomputeDriver(flow_fn, os.path.join(d, "unused"))
    for key, flow in files.items():
        v, n = key[:-4].split("/")
        load = lambda m: load_image(os.path.join(root, "cutMargin", v, f"{m}.jpg")).astype(
            np.float32)
        if flow.shape != (size, size, 2) or not np.array_equal(
                flow, driver.compute_pair(load(int(n)), load(int(n) + 25))):
            raise AssertionError(f"precompute-flow: {key} differs from its pair's flow_fn")
    if stats != {"done": pairs, "skipped": 0, "failed": 0} or len(files) != pairs:
        raise AssertionError(f"precompute-flow: {len(files)} files, stats {stats}")
    mtimes = {k: os.path.getmtime(os.path.join(root, "raft_flow_npy", k)) for k in files}
    again, (stats2, _) = run("rerun", root)
    if (stats2 != {"done": 0, "skipped": pairs, "failed": 0} or again.keys() != files.keys()
            or {k: os.path.getmtime(os.path.join(root, "raft_flow_npy", k))
                for k in files} != mtimes):
        raise AssertionError(f"precompute-flow rerun: stats {stats2}")
    bad = os.path.join(d, "corrupt")
    shutil.copytree(os.path.join(root, "cutMargin"), os.path.join(bad, "cutMargin"))
    with open(os.path.join(bad, "cutMargin", "2", "0.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    rest, (stats3, log) = run("corrupt", bad)
    if (stats3 != {"done": pairs - 1, "skipped": 0, "failed": 1} or "2/0.npy" in rest
            or "video 2 frame 0 FAILED" not in log or "Traceback" not in log
            or any(not np.array_equal(f, files[k]) for k, f in rest.items())
            or len(rest) != pairs - 1):
        raise AssertionError(f"precompute-flow with a corrupt frame: stats {stats3}")
    print(f"raft: precompute-flow wrote {pairs} pairs of 2 videos x {video_frames} frames, each "
          f"equal to its pair's flow_fn (last frames without a file); the rerun {stats2}; a "
          f"corrupt JPEG {stats3}, its traceback in the log, the other pairs equal; seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return {**out, "seconds": seconds}


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
                      lengths=CLI_LENGTHS, batch=BATCH, raft_iters=RAFT_ITERS) -> dict:
    """The extraction CLI at b3 widths (``BackboneConfig()``,
    ``HeadConfig()``) through ``cli.main``: a synthetic Cholec80-layout
    corpus -> ``prepare-data --scheme smoke``; a seeded ``FrameCache`` per
    split written here (and, when Pillow is importable, ``precompute-flow``
    over the val split's JPEGs at ``raft_iters`` iterations, then
    ``cache-frames`` over them, whose cache must carry that flow); seeded
    port models saved as reference-format ``.pth``
    files -> ``extract-features --pretrained-evp --frame-cache
    --reference-pickles`` (each store against ``extract_features`` run
    directly on the same frames, each pickle read back) -> ``reference-parity
    --online`` on those stores. ``cfg``, ``head_cfg``, ``model_flags`` and
    ``device`` size the phase down for a rehearsal on the CPU."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MSTCNConfig,
                                                RefinerConfig)
    from surgical_tpu_torch.data.datasets import FrameCache, load_flow, prefetch_batches
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
            val_paths = json.load(f)
        _write_frames(root, val_paths, rng)
        run("precompute-flow", "--root", root, "--iters", str(raft_iters), "--device", device)
        run("cache-frames", "--work", work, "--out", os.path.join(work, "pil_cache"),
            "--splits", "val")
        fc = FrameCache(os.path.join(work, "pil_cache", "val"))
        if (len(fc), fc.meta["resize"], fc.meta["with_flow"]) != (len(caches["val"]), 250, True):
            raise AssertionError(f"cache-frames: {len(fc)} frames, meta {fc.meta}")
        # the cache carries RAFT's flow: every frame but the video's last has
        # a file, non-zero, and the cache holds load_flow of each frame
        has_file = [os.path.exists(p.replace("cutMargin", "raft_flow_npy").replace(".jpg", ".npy"))
                    for p in val_paths]
        cached = np.asarray(fc.flow)
        if (sum(has_file) != len(val_paths) - 1 or has_file[-1]
                or not np.array_equal(cached, np.stack([load_flow(p, 250) for p in val_paths]))
                or not all(np.abs(cached[i]).max() > 0 for i, h in enumerate(has_file) if h)):
            raise AssertionError("cache-frames: the cache does not carry precompute-flow's flow")
        print(f"cli: precompute-flow wrote {sum(has_file)} flow files for the val split's "
              f"{len(val_paths)} frames; the frame cache holds them (max |flow| "
              f"{np.abs(cached).max():.3f} px at 250 px)")
    pil_note = ("importable: precompute-flow and cache-frames ran on the val split's JPEGs"
                if pil else "not importable: precompute-flow and cache-frames not run")
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
    return {"seconds": seconds, "agreement": agree, "work": work, "cache_root": cache_root,
            "evp": ckpt["evp"]}


# Run in a fresh process by phase_export: loads artifacts with
# serving/export.py's loader alone, runs them on .npy inputs, and prints one
# JSON line (load seconds, ms per call or per streamed frame, kernel launches
# when kernels.ops was loaded, the modules the load and the calls imported).
_ARTIFACT_RUNNER = r"""
import json, sys, time
import numpy as np
import torch

before = set(sys.modules)
from surgical_tpu_torch.serving.export import load_artifact

job = json.load(open(sys.argv[1]))
dev = job["device"]
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
t0 = time.perf_counter()
fns = [load_artifact(d) for d in job["artifacts"]]
sync()
res = {"load_s": time.perf_counter() - t0}
ins = [torch.from_numpy(np.load(p)).to(dev) for p in job["inputs"]]
mb = sys.modules.get("surgical_tpu_torch.kernels.mit_block")


def launches():
    if mb is None:
        return None
    return {"mit_block_forward": mb.fused_mit_block.launches,
            "mit_block_packed2_forward": mb.fused_mit_block_packed2.launches,
            "mit_stage_forward": mb.fused_mit_stage.launches}


def zeros(aval):
    name, dims = aval[:-1].split("[")
    return torch.zeros([int(d) for d in dims.split(",") if d], dtype=getattr(torch, name),
                       device=dev)


if job["mode"] == "call":
    fn = fns[0]
    fn(*ins)
    sync()
    if mb is not None:
        mb.reset_launches()
    out = fn(*ins)
    sync()
    res["launches"] = launches()
    for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
        np.save(f"{job['out']}{i}.npy", o.cpu().numpy())
    times = []
    for _ in range(job["reps"]):
        sync()
        t = time.perf_counter()
        fn(*ins)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    res["ms"] = float(np.median(times))
    if dev == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn(*ins)
            sync()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        res["device_ms"] = sum(e.time_range.end - e.time_range.start for e in evs) / 1e3
        res["device_ops"] = len(evs)
else:
    # frame-in / phase-out: the B = 1 backbone (features rounded to the f16
    # extraction wire, as OnlineSession), the temporal step from its zero
    # state (the manifest's shapes), the refiner step on its final stage
    backbone, temporal, refiner = fns
    img, seg, flow = ins

    def stream(n):
        state = [zeros(a) for a in temporal.manifest["in_avals"][:-1]]
        buf = zeros(refiner.manifest["in_avals"][0])
        outs, ms = [], []
        for t in range(n):
            t1 = time.perf_counter()
            feat = backbone(img[t:t + 1], seg[t:t + 1], flow[t:t + 1])[0]
            feat = feat.to(torch.float16).float()
            *state, logits = temporal(*state, feat)
            buf, refined = refiner(buf, logits[-1], feat)
            outs.append(refined.cpu().numpy())
            ms.append((time.perf_counter() - t1) * 1e3)
        return np.stack(outs), ms

    stream(1)
    if mb is not None:
        mb.reset_launches()
    outs, ms = stream(len(img))
    res["launches"] = launches()
    res["ms_per_frame"] = float(np.median(ms))
    np.save(f"{job['out']}0.npy", outs)
res["new_modules"] = sorted(set(sys.modules) - before)
if "eager" in job:
    # the eager graph (or session) on the same inputs in this same process,
    # timed the same way, after the artifact's modules were recorded
    from surgical_tpu_torch.train.extract import WireForward

    mods = torch.load(job["eager"], weights_only=False, map_location=dev)
    with torch.no_grad():
        if job["mode"] == "call":
            serve = WireForward(mods["model"], job["fused"], out_dtype=torch.float32)
            serve(*ins)
            times = []
            for _ in range(job["reps"]):
                sync()
                t = time.perf_counter()
                serve(*ins)
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            res["eager_ms"] = float(np.median(times))
        else:
            from surgical_tpu_torch.serving.online import (OnlineMSTCN, OnlineRefiner,
                                                           OnlineSession)

            session = OnlineSession(mods["model"], OnlineMSTCN(mods["mstcn"]),
                                    OnlineRefiner(mods["refiner"]))
            session.step(img[0], seg[0], flow[0])
            session.reset()
            ms = []
            for t in range(len(img)):
                t1 = time.perf_counter()
                session.step(img[t], seg[t], flow[t])
                ms.append((time.perf_counter() - t1) * 1e3)
            res["eager_ms_per_frame"] = float(np.median(ms))
print(json.dumps(res))
"""


def _run_artifacts(root: str, name: str, job: dict) -> dict:
    """Run ``_ARTIFACT_RUNNER`` on ``job`` in a fresh Python process; returns
    its report with the outputs it saved. Raises on a nonzero exit, or when
    the process imported the model code, JAX, or (without a fused artifact)
    the kernels."""
    path = os.path.join(root, f"{name}.json")
    job = {**job, "out": os.path.join(root, f"{name}_out")}
    with open(path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    proc = subprocess.run([sys.executable, "-c", _ARTIFACT_RUNNER, path], capture_output=True,
                          text=True, env=env, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"artifact run {name} failed:\n{proc.stderr[-4000:]}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ("surgical_tpu_torch.models", "surgical_tpu_torch.train", "surgical_tpu.", "jax",
              "flax") + (() if rep["launches"] is not None else ("surgical_tpu_torch.kernels",))
    bad = [m for m in rep["new_modules"] if m.startswith(banned) or m == "surgical_tpu"]
    if bad:
        raise AssertionError(f"artifact run {name} imported {bad[:5]}")
    outs, i = [], 0
    while os.path.exists(f"{job['out']}{i}.npy"):
        outs.append(np.load(f"{job['out']}{i}.npy"))
        i += 1
    rep["outputs"] = outs
    return rep


def _host_us_per_call(fn, calls: int = 100) -> float:
    """Host microseconds per call of ``fn`` issued back to back (the issue
    cost: the device work queues behind it), after a synchronization."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def phase_export(workdir: str, cfg=None, head_cfg=None, model_flags=(), device="cuda",
                 size: int = 224, batch: int = BATCH, frames: int = SESSION_FRAMES,
                 reps: int = EXPORT_REPS) -> dict:
    """The deployment leg at b3 widths with flow: ``cli export-serving`` of
    a seeded reference-format ``.pth``, the flax graph and ``--fused``, at
    ``batch`` and at 1 (export seconds and artifact bytes); the streaming
    MS-TCN and refiner steps exported beside them; each backbone artifact run
    in a fresh process that imports torch and the loader (and
    ``kernels.ops`` for a fused one) and no model code: its outputs equal
    the eager graph's bit for bit, its load seconds, its ms per call beside
    the eager graph's (timed after it in the same process, whose state
    sways a host-bound call) and device time per call beside the eager
    graph's, and the kernel launches of one call (a fused artifact at ``batch``: the block
    kernel per block of stages 1-3 and the stage kernel once); then the
    ``frames``-frame stream through the three artifacts (fused backbone at
    B = 1, MS-TCN step, refiner step) in one such process, equal to
    ``OnlineSession`` bit for bit, with its ms per frame beside the eager
    session's and the block launches per frame; and the host cost of one
    custom-op dispatch against the bare launch. ``cfg``, ``head_cfg``,
    ``model_flags``, ``size`` and ``device`` size it down for a rehearsal on
    the CPU, where nothing is timed or counted."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MSTCNConfig,
                                                RefinerConfig)
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models import mit_fused as mf
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.export import (export_online_refiner,
                                                   export_online_temporal, save_artifact)
    from surgical_tpu_torch.serving.online import OnlineMSTCN, OnlineRefiner, OnlineSession
    from surgical_tpu_torch.train.extract import WireForward

    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    cuda = device == "cuda"
    root = os.path.join(workdir, "export")
    os.makedirs(root)
    f_dim = head_cfg.embedding_dim
    model = MiTEVP(cfg, head_cfg, seed=SEED + 30, device=device)
    pth = os.path.join(root, "evp.pth")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)
    mstcn = MultiStageTCN(MSTCNConfig(f_dim=f_dim), seed=SEED + 31, device=device)
    refiner = RefinementTransformer(RefinerConfig(f_dim=f_dim), seed=SEED + 32, device=device)
    rng = np.random.default_rng(SEED + 30)
    n = max(batch, frames)
    wire = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8),
            rng.standard_normal((n, size, size, 2), dtype=np.float32).astype(np.float16))
    eager = os.path.join(root, "eager_models.pt")
    torch.save({"model": model, "mstcn": mstcn, "refiner": refiner}, eager)
    inputs = {}
    for B in (batch, 1, frames):
        inputs[B] = []
        for i, a in enumerate(wire):
            inputs[B].append(os.path.join(root, f"in_b{B}_{i}.npy"))
            np.save(inputs[B][-1], a[:B])

    res = {"export_s": {}, "bytes": {}, "load_s": {}, "ms": {}, "eager_ms": {}, "launches": {},
           "device": {}}
    names = [(g, B) for g in ("flax", "fused") for B in (batch, 1)]
    for graph, B in names:
        name, d = f"{graph}_b{B}", os.path.join(root, f"{graph}_b{B}")
        t = time.perf_counter()
        if cli.main(["export-serving", "--out", d, "--pretrained-evp", pth, "--batch-size",
                     str(B), "--size", str(size), "--device", device, *model_flags,
                     *(["--fused"] if graph == "fused" else [])]) != 0:
            raise AssertionError(f"cli export-serving {name} failed")
        res["export_s"][name] = time.perf_counter() - t
        with open(os.path.join(d, "manifest.json")) as f:
            m = json.load(f)
        if m["platforms"] != [device] or m["surgical_tpu_ops"] != (graph == "fused"):
            raise AssertionError(f"{name}: manifest {m}")
        res["bytes"][name] = m["bytes"]
    steps = {"mstcn_step": export_online_temporal(OnlineMSTCN(mstcn), f_dim),
             "refiner_step": export_online_refiner(OnlineRefiner(refiner))}
    for name, ep in steps.items():
        save_artifact(os.path.join(root, name), ep, meta={"model": name})
    print(f"export: {len(names)} backbone artifacts via cli export-serving "
          + ", ".join(f"{k} {v:.2f} s / {res['bytes'][k] / 2**20:.1f} MiB"
                      for k, v in res["export_s"].items()) + "; the MS-TCN and refiner steps")

    blocks = sum(cfg.depths[:3]) + (0 if batch % mf._FUSE_BT[4] == 0 else cfg.depths[3])
    for graph, B in names:
        name = f"{graph}_b{B}"
        serve = WireForward(model, graph == "fused", out_dtype=torch.float32)
        dev_in = [torch.from_numpy(a[:B]).to(device) for a in wire]
        with torch.no_grad():
            want = serve(*dev_in).cpu().numpy()
            if cuda:
                busy, ops = device_busy(lambda: serve(*dev_in))
        rep = _run_artifacts(root, name, {"mode": "call", "device": device, "reps": reps,
                                          "artifacts": [os.path.join(root, name)],
                                          "inputs": inputs[B], "eager": eager,
                                          "fused": graph == "fused"})
        if len(rep["outputs"]) != 1 or not np.array_equal(rep["outputs"][0], want):
            raise AssertionError(f"{name}: the artifact's features differ from the eager graph")
        res["load_s"][name], res["launches"][name] = rep["load_s"], rep["launches"]
        if cuda:
            res["ms"][name], res["eager_ms"][name] = rep["ms"], rep["eager_ms"]
            res["device"][name] = {"eager_ms": busy, "eager_ops": ops,
                                   "artifact_ms": rep["device_ms"],
                                   "artifact_ops": rep["device_ops"]}
        if graph == "fused" and B == batch and cuda and rep["launches"] != {
                "mit_block_forward": blocks, "mit_block_packed2_forward": 0,
                "mit_stage_forward": int(blocks == sum(cfg.depths[:3]))}:
            raise AssertionError(f"{name}: launches {rep['launches']}")
        print(f"export {name}: equal to the eager graph bit for bit in a process with torch "
              f"alone{' + kernels.ops' if graph == 'fused' else ''}; load {rep['load_s']:.2f} s"
              + (f", {rep['ms']:.3f} ms per call (eager {res['eager_ms'][name]:.3f}); device "
                 f"{rep['device_ms']:.3f} ms in {rep['device_ops']} operations (eager {busy:.3f} "
                 f"in {ops})" if cuda else "") + f"; launches per call {rep['launches']}")

    session = OnlineSession(model, OnlineMSTCN(mstcn), OnlineRefiner(refiner))
    frame = lambda t: tuple(a[t] for a in wire)
    want = [session.step(*frame(t)) for t in range(frames)]
    rep = _run_artifacts(root, "stream", {
        "mode": "stream", "device": device, "inputs": inputs[frames], "eager": eager,
        "artifacts": [os.path.join(root, k) for k in ("fused_b1", "mstcn_step", "refiner_step")]})
    if not np.array_equal(rep["outputs"][0], np.stack(want)):
        raise AssertionError("the three-artifact stream differs from OnlineSession")
    per_frame = sum(cfg.depths)
    if cuda and rep["launches"] != {"mit_block_forward": per_frame * frames,
                                    "mit_block_packed2_forward": 0, "mit_stage_forward": 0}:
        raise AssertionError(f"stream launches {rep['launches']}")
    res["launches"]["stream"] = rep["launches"]
    res["stream"] = {"frames": frames, "load_s": rep["load_s"]}
    if cuda:
        res["stream"].update(ms_per_frame=rep["ms_per_frame"],
                             session_ms_per_frame=rep["eager_ms_per_frame"])
    print(f"export stream: {frames} frames through the fused B = 1, MS-TCN and refiner step "
          f"artifacts equal OnlineSession bit for bit; launches {rep['launches']}"
          + (f"; {rep['ms_per_frame']:.3f} ms per frame (eager session "
             f"{res['stream']['session_ms_per_frame']:.3f})" if cuda else ""))

    if cuda:
        # one custom-op dispatch against the bare launch, stage 4's block at B = 1
        side = size
        for k, st, p in ((7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1)):
            side = (side + 2 * p - k) // st + 1
        C, heads = cfg.embed_dims[3], cfg.num_heads[3]
        w = mf.kernel_weights(model)["block4"][0]
        x, k, v = (torch.randn(1, side * side, C, device=device, dtype=torch.bfloat16)
                   for _ in range(3))
        with torch.no_grad():
            op_us, raw_us = [], []
            for _ in range(3):
                op_us.append(_host_us_per_call(
                    lambda: mb.fused_mit_block(x, k, v, w, heads=heads, H=side, W=side)))
                raw_us.append(_host_us_per_call(
                    lambda: mb.mit_block_forward_cuda(x, k, v, w, heads=heads, H=side, W=side)))
        res["dispatch_us"] = {"op": float(np.median(op_us)), "launch": float(np.median(raw_us))}
        extra = res["dispatch_us"]["op"] - res["dispatch_us"]["launch"]
        print(f"time export: custom-op dispatch {res['dispatch_us']['op']:.1f} us per call "
              f"against the bare launch's {res['dispatch_us']['launch']:.1f} us: "
              f"{extra:.1f} us per call, {extra * per_frame / 1e3:.3f} ms per streamed frame "
              f"({per_frame} calls)")
    print(json.dumps({"export": {k: v for k, v in res.items() if k != "launches"}}))
    return res


def phase_int8(cfg=None, head_cfg=None, device="cuda", size: int = 224, batch: int = BATCH,
               n_batches: int = INT8_BATCHES, runs: int = INT8_RUNS) -> dict:
    """``extract-features --weight-quant int8``'s path at b3 widths with
    flow: ``make_raw_feature_fn`` with bf16 and with int8 weights on the
    same ``n_batches`` batches of ``batch`` seeded wire frames. The int8
    features equal the bf16 graph on a model whose weights were set to the
    dequantized values, bit for bit, with the block and stage kernels'
    launches of that run; the held bytes (int8 + fp32 scales against bf16);
    scripts/probe_int8.py's metrics (feature median relative error and
    correlation, gated at the JAX package's test bounds; a seeded MS-TCN
    (2 stages x 8 layers, 32 maps) and refiner on each: final-stage and
    refined logits MAE, anticipation MAE delta, phase argmax agreement);
    on the card frames/s of each, median of ``runs`` runs in turns, and the
    dequantization's device ms per batch. ``cfg``, ``head_cfg``, ``size``
    and ``device`` size it down for a rehearsal on the CPU, where nothing is
    timed or counted."""
    from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MSTCNConfig,
                                                RefinerConfig)
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models import mit_fused as mf
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import MultiStageTCN
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.quant import dequantize_state, quantize_state
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn

    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    cuda = device == "cuda"
    f_dim, n = head_cfg.embedding_dim, batch * n_batches
    model = MiTEVP(cfg, head_cfg, seed=SEED + 40, device=device)
    rng = np.random.default_rng(SEED + 40)
    wire = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8),
            rng.standard_normal((n, size, size, 2), dtype=np.float32).astype(np.float16))
    batches = [tuple(a[i:i + batch] for a in wire) for i in range(0, n, batch)]
    fns = {"bf16": make_raw_feature_fn(model),
           "int8": make_raw_feature_fn(model, weight_quant="int8")}
    extract = lambda fn: extract_features(fn, batches, n, f_dim, batch)
    for fn in fns.values():
        extract(fn)  # warm-up
    mb.reset_launches()
    feats_q, _ = extract(fns["int8"])
    launches = {"mit_block_forward": mb.fused_mit_block.launches,
                "mit_stage_forward": mb.fused_mit_stage.launches}
    stage_route = batch % mf._FUSE_BT[4] == 0
    want = {"mit_block_forward": n_batches * (sum(cfg.depths[:3])
                                             + (0 if stage_route else cfg.depths[3])),
            "mit_stage_forward": n_batches * int(stage_route)}
    if cuda and launches != want:
        raise AssertionError(f"int8 extraction launches {launches}, expected {want}")
    feats, _ = extract(fns["bf16"])

    q_state, scales = quantize_state(model.state_dict())
    ref = MiTEVP(cfg, head_cfg, seed=SEED + 40, device=device)
    ref.load_state_dict({k: v.float() if k in scales else v
                         for k, v in dequantize_state(q_state, scales).items()})
    ref_feats, _ = extract(make_raw_feature_fn(ref))
    if not np.array_equal(feats_q, ref_feats):
        raise AssertionError("int8 features differ from the graph on the dequantized weights")
    held_q, held_s = fns["int8"].held
    if any(t.dtype != torch.int8 or t.device.type != device for t in held_q.values()):
        raise AssertionError("the int8 path does not hold int8 weights on the device")
    res = {"frames": n, "quantized_tensors": len(held_q), "launches": launches,
           "bytes_int8": sum(t.numel() for t in held_q.values())
           + sum(4 * s.numel() for s in held_s.values()),
           "bytes_bf16": sum(2 * t.numel() for t in held_q.values())}

    rel = np.abs(feats - feats_q) / np.maximum(np.abs(feats), 1e-3)
    res["feature_median_rel_err"] = float(np.median(rel))
    res["feature_corr"] = float(np.corrcoef(feats.ravel(), feats_q.ravel())[0, 1])
    mstcn = MultiStageTCN(MSTCNConfig(stages=2, layers=8, f_maps=32, f_dim=f_dim),
                          seed=SEED + 41, device=device)
    refiner = RefinementTransformer(RefinerConfig(f_maps=32, f_dim=f_dim), seed=SEED + 42,
                                    device=device)
    with torch.no_grad():
        outs = {}
        for name, f in (("bf16", feats), ("int8", feats_q)):
            lfb = torch.tensor(f, device=device)
            g = mstcn(lfb[None])[-1, 0]
            outs[name] = (g.cpu().numpy(), refiner(g, lfb).cpu().numpy())
    (ga, ra), (gb, rb) = outs["bf16"], outs["int8"]
    res.update(mstcn_final_mae=float(np.abs(ga - gb).mean()),
               logits_mae=float(np.abs(ra - rb).mean()),
               anticipation_mae_delta=float(np.abs(ra[:, 7:] - rb[:, 7:]).mean()),
               mstcn_argmax_agreement=float((ga[:, :7].argmax(-1) == gb[:, :7].argmax(-1)).mean()),
               phase_argmax_agreement=float((ra[:, :7].argmax(-1) == rb[:, :7].argmax(-1)).mean()))
    print(f"int8: {res['quantized_tensors']} tensors held as int8 ({res['bytes_int8'] / 2**20:.2f} "
          f"MiB with scales, bf16 {res['bytes_bf16'] / 2**20:.2f} MiB); features equal the "
          f"graph on the dequantized weights bit for bit; launches {launches}; vs bf16: median "
          f"rel {res['feature_median_rel_err']:.4f} (gate {INT8_MEDIAN_REL}), corr "
          f"{res['feature_corr']:.5f} (gate {INT8_CORR}), MS-TCN final MAE "
          f"{res['mstcn_final_mae']:.3e}, refined MAE {res['logits_mae']:.3e}, anticipation "
          f"MAE delta {res['anticipation_mae_delta']:.3e}, argmax agreement MS-TCN "
          f"{res['mstcn_argmax_agreement']:.4f}, refined {res['phase_argmax_agreement']:.4f}")
    if not (res["feature_median_rel_err"] < INT8_MEDIAN_REL and res["feature_corr"] > INT8_CORR):
        raise AssertionError("int8 features fail the JAX package's gates")
    if cuda:
        fps = {"bf16": [], "int8": []}
        for r in range(runs):
            for name in (("bf16", "int8") if r % 2 == 0 else ("int8", "bf16")):
                fps[name].append(extract(fns[name])[1]["fps"])
        res["fps"] = {k: float(np.median(v)) for k, v in fps.items()}
        res["fps_runs"] = fps
        res["dequant_ms"] = time_ms(lambda: dequantize_state(held_q, held_s))
        res["dequant_device_ms"], res["dequant_device_ops"] = device_busy(
            lambda: dequantize_state(held_q, held_s))
        print(f"time int8: frames/s bf16 {res['fps']['bf16']:.1f}, int8 {res['fps']['int8']:.1f} "
              f"(median of {runs}, in turns; runs {fps}); dequantization "
              f"{res['dequant_ms']:.3f} ms per batch (CUDA events, host issue included), device "
              f"{res['dequant_device_ms']:.3f} ms in {res['dequant_device_ops']} operations")
    print(json.dumps({"int8": res}))
    return res

def _extraction_launches(batch: int) -> dict:
    """The b3 serving graph's kernel launches per batch of ``batch`` frames:
    the block wrapper at stages 1-3 (3 + 4 + 18), and stage 4 on the stage
    kernel at a multiple of 8, else its 3 blocks on the block kernel."""
    return ({"mit_block_forward": 25, "mit_stage_forward": 1} if batch % 8 == 0
            else {"mit_block_forward": 28, "mit_stage_forward": 0})


_LAUNCH_LINE = re.compile(r"^(\w+): kernel launches per rank (\[.*\])$", re.M)


def phase_multirank_cli(workdir: str, cli: dict, model_flags=(), device="cuda:0",
                        backend="gloo", batch: int = BATCH, ranks: int = DP_RANKS) -> dict:
    """``extract-features`` under ``python -m torch.distributed.run
    --nproc-per-node ranks`` on phase 11's corpus (``cli``: its work dir,
    frame caches and ``.pth``) at ``batch``, against one process at
    ``batch / ranks`` (``cli.main`` in this process) in a work dir of its own:
    every split's store equal bit for bit, the pickles written, and, on the
    card, each rank's launches per batch those of one process at ``batch /
    ranks`` (28 block launches and no stage launch at 100 frames). Both run
    with one CPU thread. ``model_flags`` and ``device`` size it down for the
    CPU."""
    from surgical_tpu_torch import cli as cli_mod
    from surgical_tpu_torch.data.feature_store import FeatureStore

    runs = {name: {"work": os.path.join(workdir, "multirank_cli", name)}
            for name in ("one_process", "ranks")}
    argv = lambda name, b: ["extract-features", "--work", runs[name]["work"], *model_flags,
                            "--batch-size", str(b), "--device", device, "--pretrained-evp",
                            cli["evp"], "--frame-cache", cli["cache_root"], "--reference-pickles"]
    for r in runs.values():
        shutil.copytree(os.path.join(cli["work"], "index"), os.path.join(r["work"], "index"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the torchrun workers' one OpenMP thread
    t = time.perf_counter()
    try:
        if cli_mod.main(argv("one_process", batch // ranks)) != 0:
            raise AssertionError("extract-features (one process) failed")
    finally:
        torch.set_num_threads(threads)
    runs["one_process"]["seconds"] = time.perf_counter() - t
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(ranks), "-m", "surgical_tpu_torch.cli", *argv("ranks", batch), "--dist-backend",
           backend]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"extract-features over {ranks} ranks exited {proc.returncode}:"
                             f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    runs["ranks"].update(stdout=proc.stdout, seconds=time.perf_counter() - t)
    launches = {m.group(1): json.loads(m.group(2))
                for m in _LAUNCH_LINE.finditer(runs["ranks"]["stdout"])}
    per = batch // ranks
    per_batch = (_extraction_launches(per)
                 if device != "cpu" else {"mit_block_forward": 0, "mit_stage_forward": 0})
    splits = sorted(os.listdir(os.path.join(runs["one_process"]["work"], "lfb")))
    splits = [s for s in splits if not s.endswith(".pkl")]
    for split in splits:
        got, want = (FeatureStore.open(os.path.join(runs[k]["work"], "lfb", split))
                     for k in ("ranks", "one_process"))
        if not np.array_equal(np.asarray(got.features), np.asarray(want.features)):
            raise AssertionError(f"{split}: the {ranks}-rank store differs from one process at "
                                 f"batch {per}")
        if not os.path.exists(os.path.join(runs["ranks"]["work"], "lfb", f"evp_LFB_{split}.pkl")):
            raise AssertionError(f"{split}: rank 0 wrote no reference pickle")
        n_batches = -(-len(got.features) // batch)
        want_l = {k: v * n_batches for k, v in per_batch.items()}
        got_l = [{k: r[k] for k in want_l} for r in launches.get(split, [])]
        print(f"multirank cli: {split}: {len(got.features)} frames, {n_batches} batches of "
              f"{batch} ({per} per rank): launches per rank {got_l} (expected {want_l} each: "
              f"per batch {per_batch['mit_block_forward'] - 4 * (device != 'cpu')} of the block "
              f"at stages 1, 3 and 4's blocks, {4 * (device != 'cpu')} at stage 2); "
              f"store equal to one process at batch {per} bit for bit")
        if got_l != [want_l] * ranks:
            raise AssertionError(f"{split}: launches per rank {got_l}, expected {want_l}")
    seconds = {k: r["seconds"] for k, r in runs.items()}
    print("multirank cli: seconds " + ", ".join(f"{k} {s:.3f}" for k, s in seconds.items()))
    return {"seconds": seconds, "launches": launches, "splits": splits}


def phase_cross_device() -> dict:
    """With two or more cards: the block kernel (stage 1, B = CHECK_B) and
    the scan (T = 2000) launched on tensors on cuda:1 while the current
    device is 0, against the same launch on cuda:0, bit for bit."""
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.kernels import selective_scan as ss

    torch.cuda.set_device(0)
    rng = np.random.default_rng(SEED + 40)
    C, side, heads = 64, 56, 1
    w = _block_weights(rng, C, 4 * C)
    x, k, v = (_rand(rng, s) for s in ((CHECK_B, side * side, C), (CHECK_B, 49, C),
                                       (CHECK_B, 49, C)))
    scan = scan_inputs(rng, 1, 2000)
    with torch.no_grad():
        on = {d: (mb.fused_mit_block(x.to(d), k.to(d), v.to(d),
                                     {n: t.to(d) for n, t in w.items()}, heads=heads, H=side,
                                     W=side),
                  ss.selective_scan_forward(*(t.to(d) for t in scan))[0])
              for d in ("cuda:0", "cuda:1")}
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    equal = [torch.equal(a.cpu(), b.cpu()) for a, b in zip(on["cuda:0"], on["cuda:1"])]
    print(f"multirank: block kernel and scan on cuda:1 from current device "
          f"{torch.cuda.current_device()}: equal to cuda:0 bit for bit {equal}")
    if not all(equal):
        raise AssertionError("a kernel launched on cuda:1 differs from cuda:0")
    return {"equal": equal}


def phase_multirank(workdir: str, cli: dict) -> dict:
    """Multi-rank paths on the card (constants above DP_RANKS): the probe
    that the backend takes CUDA tensors in each collective, the time-sharded
    MS-TCN and Mamba, data-parallel extraction, the batch-sharded b3 step in fp32 and
    bf16 (DP_RANKS ranks in one spawn), MS-TCN with a multi-chunk halo
    (DP_HOP_RANKS ranks), the cross-device launch where there are two cards,
    and the extraction CLI under torch.distributed.run. Launches per rank,
    distances and seconds per leg."""
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, MambaConfig, MSTCNConfig
    from surgical_tpu_torch.parallel import dryrun, mesh

    cards = torch.cuda.device_count()
    place = lambda n: (("cuda", "nccl") if cards >= n else ("cuda:0", "gloo"))
    device, backend = place(DP_RANKS)
    print(f"multirank: {DP_RANKS} ranks, backend {backend}, "
          f"{'one card per rank' if backend == 'nccl' else 'every rank on cuda:0'} "
          f"({cards} card(s) here)")
    cfg, head = BackboneConfig(), HeadConfig()
    mcfg = MambaConfig()
    legs = [
        (dryrun.probe_leg, {}),
        (dryrun.temporal_leg, dict(kind="mstcn", cfg=MSTCNConfig(), T=DP_T, seed=SEED + 30)),
        (dryrun.temporal_leg, dict(kind="mamba", cfg=mcfg, T=DP_T, seed=SEED + 31)),
        (dryrun.extract_leg, dict(cfg=cfg, head_cfg=head, frames=DP_EXTRACT_B,
                                  batch=DP_EXTRACT_B, size=224, seed=SEED + 32)),
        (dryrun.step_leg, dict(cfg=cfg, head_cfg=head, batch=DP_STEP_FP32_B, resize=250,
                               crop=224, dtype=torch.float32, seed=SEED + 33)),
        (dryrun.step_leg, dict(cfg=cfg, head_cfg=head, batch=TRAIN_B, resize=250, crop=224,
                               dtype=torch.bfloat16, use_fused=True, seed=SEED + 34)),
    ]
    t = time.perf_counter()
    ranks = dryrun.spawn(dryrun.run_legs, DP_RANKS, legs, device=device, backend=backend)
    seconds = {"spawn_2_ranks": time.perf_counter() - t}
    probe, mstcn, mamba, ext, fp32, bf16 = ranks[0]
    names = ("mstcn", "mamba", "extract", "step_fp32", "step_bf16")
    seconds.update({n: max(r[i + 1]["seconds"] for r in ranks) for i, n in enumerate(names)})
    res = {"backend": backend, "probe": probe}
    refused = {op: err for op, err in probe.items() if err is not None}
    print(f"multirank: {backend} takes CUDA tensors in "
          f"{sorted(op for op in mesh.COLLECTIVES if op not in refused)}, refuses {refused}")
    if refused or set(probe) != set(mesh.COLLECTIVES):
        raise AssertionError(f"{backend} refuses collectives on CUDA tensors: {refused}")

    for name, r, bound in (("MS-TCN", mstcn, DP_MSTCN_BOUND), ("Mamba", mamba, DP_MAMBA_BOUND)):
        print(f"multirank: {name} T={DP_T} over {DP_RANKS} ranks vs one rank: max abs "
              f"{r['max_abs']:.3e} (bound {bound:g}, max |ref| {np.abs(r['ref']).max():.3f})")
        if not r["max_abs"] <= bound:
            raise AssertionError(f"time-sharded {name} off the one-rank model")
    scan_l = [r[2]["scan_launches"] for r in ranks]
    print(f"multirank: Mamba selective_scan_forward calls per rank {scan_l} (one per layer: "
          f"{mcfg.layers})")
    if scan_l != [mcfg.layers] * DP_RANKS:
        raise AssertionError("the time-sharded Mamba did not run the scan kernel once per layer")

    ext_l = [{k: r[3]["launches"][k] for k in ("mit_block_forward", "mit_stage_forward")}
             for r in ranks]
    per = DP_EXTRACT_B // DP_RANKS
    want = _extraction_launches(per)
    print(f"multirank: extraction of {DP_EXTRACT_B} frames ({per} per rank): launches per rank "
          f"{ext_l} (expected {want}: {want['mit_block_forward'] - 4} of the block at stages "
          f"1, 3 and 4's blocks, 4 at stage 2); equal to one rank on each shard bit for bit "
          f"{ext['equal']}; a batch that does not divide raised on every rank "
          f"{all(r[3]['odd_batch_raised'] for r in ranks)}, and came back whole without a "
          f"group {all(r[3]['alone_rows'] == r[3]['odd'] for r in ranks)}")
    if (ext_l != [want] * DP_RANKS or not ext["equal"]
            or not all(r[3]["odd_batch_raised"] for r in ranks)
            or not all(r[3]["alone_rows"] == r[3]["odd"] for r in ranks)):
        raise AssertionError("data-parallel extraction")

    for name, r, idx, bound in (("fp32 flax graph", fp32, 4, DP_FP32_BOUND),
                                ("bf16 fused trunk", bf16, 5, DP_BF16_BOUND)):
        same = len({rk[idx]["hash"] for rk in ranks}) == 1
        dist_keys = (("loss_rel", "grad_rel_l2", "bn_rel_l2", "param_rel_l2")
                     if idx == 4 else ("loss_rel", "grad_rel_l2"))
        print(f"multirank: b3 step, {name}, {r['grads']} trainable tensors, batch "
              f"{DP_STEP_FP32_B if idx == 4 else TRAIN_B} over {DP_RANKS} ranks vs one rank: "
              + ", ".join(f"{k} {r[k]:.3e}" for k in dist_keys)
              + f" (bound {bound:g}); loss {r['loss']:.4f} vs {r['ref_loss']:.4f}; BatchNorm "
              f"statistics moved rel {r['bn_moved']:.3e}; states after the step equal across "
              f"ranks {same}")
        if max(r[k] for k in dist_keys) > bound or not same or not r["bn_moved"] > 0:
            raise AssertionError(f"the batch-sharded step ({name}) off the one-rank step")
    train_l = [{k: v for k, v in r[5]["launches"].items() if "train" in k} for r in ranks]
    print(f"multirank: bf16 step train-kernel launches per rank {train_l} (expected 28 each)")
    if any(set(d.values()) != {28} for d in train_l):
        raise AssertionError("the batch-sharded fused step did not launch each train kernel 28 "
                             "times per rank")

    hop_device, hop_backend = place(DP_HOP_RANKS)
    t = time.perf_counter()
    hop = dryrun.spawn(dryrun.run_legs, DP_HOP_RANKS,
                       [(dryrun.temporal_leg, dict(kind="mstcn", cfg=MSTCNConfig(), T=DP_HOP_T,
                                                   seed=SEED + 35))],
                       device=hop_device, backend=hop_backend)[0][0]
    seconds["spawn_4_ranks_mstcn"] = time.perf_counter() - t
    halo = 2 * 2 ** (MSTCNConfig().layers - 1)
    print(f"multirank: MS-TCN T={DP_HOP_T} over {DP_HOP_RANKS} ranks ({hop_backend}; the last "
          f"layer's {halo}-frame halo over {DP_HOP_T // DP_HOP_RANKS}-frame chunks) vs one rank: "
          f"max abs {hop['max_abs']:.3e} (bound {DP_MSTCN_BOUND:g})")
    if not hop["max_abs"] <= DP_MSTCN_BOUND:
        raise AssertionError("time-sharded MS-TCN with a multi-chunk halo off the one-rank model")

    if cards >= 2:
        res["cross_device"] = phase_cross_device()
    cl = phase_multirank_cli(workdir, cli, device="cuda" if backend == "nccl" else device,
                             backend=backend)
    seconds.update({f"cli_{k}": s for k, s in cl["seconds"].items()})
    print("multirank: seconds per leg " + ", ".join(f"{k} {s:.3f}" for k, s in seconds.items())
          + " (ranks sharing one card: not a multi-GPU scaling figure)" * (backend == "gloo"))
    res.update(seconds=seconds, launches_per_rank={
        "mit_block_forward": [d["mit_block_forward"] for d in ext_l],
        "mit_stage_forward": [d["mit_stage_forward"] for d in ext_l],
        "selective_scan_forward": scan_l,
        **{k: [d[k] for d in train_l] for k in train_l[0]}},
        cli_launches=cl["launches"])
    return res


def host_cpu() -> str:
    """The host CPU's model name from /proc/cpuinfo. Where the host reports
    it as unknown (a sandboxed kernel may), the vendor, family, model and
    clock beside it."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name.lower() != "unknown":
        return name
    ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz")
           if fields.get(k)]
    return f"model name {name or 'unknown'} ({', '.join(ids) or 'no other field'})"


def _decoder_check(workdir: str, smi: str, n: int, side: int, resize_to: int, rng) -> dict:
    """Phase 16 (a): whether the native decoder built (the machine's fact,
    printed with the reason where not, not a failure). Where Pillow can
    write the corpus, ``n`` JPEG frames and segmaps of ``side`` px written as
    phase 11 writes its own, and ``ClipDataset.frames``' frames/s on the
    route that runs here (best of 2). Where the decoder built, also: two
    native runs equal bit for bit, the native route equal to the decoder's
    batch, |native - PIL| at the wire size and resized to ``resize_to``, and
    both routes' frames/s in turns."""
    from surgical_tpu_torch import native
    from surgical_tpu_torch.data.datasets import ClipDataset

    cpu = host_cpu()
    built = native.available()
    res = {"built": built, "host_cpu": cpu, "card": smi}
    if not built:
        res["reason"] = native.failure()
        print(f"completion: native frame decoder not built; ClipDataset decodes with PIL "
              f"(reason: {res['reason']})")
    try:
        from PIL import Image
    except ImportError:
        print("completion: decoder not timed: Pillow not importable to write a corpus")
        return res
    paths = []
    for i in range(n):
        p = os.path.join(workdir, "decode", "cutMargin", "1", f"{i}.jpg")
        for path in (p, p.replace("cutMargin", "ss_Bimasks_pos_ep10")):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(path)
        paths.append(p)
    labels, idx = np.zeros((n, 15), np.float32), np.arange(n)
    routes = ("native", "pil") if built else ("pil",)
    rates, out = {r: [] for r in routes}, {}
    for route in routes * 2:
        ds = ClipDataset(paths, labels, resize=side, with_flow=False,
                         use_native=route == "native")
        t = time.perf_counter()
        out[route] = ds.frames(idx)
        rates[route].append(n / (time.perf_counter() - t))
    res.update(frames=n, size=side, threads=os.cpu_count(),
               frames_per_s={k: max(v) for k, v in rates.items()})
    where = f"[host CPU {cpu}, {os.cpu_count()} cores; card {smi}]"
    if not built:
        print(f"completion: PIL route, ClipDataset.frames on {n} {side}-px JPEG frames + "
              f"segmaps: {res['frames_per_s']['pil']:.1f} frames/s (best of 2, 1 thread) {where}")
        return res
    one, f1 = native.decode_resize_batch(paths, side)
    two, f2 = native.decode_resize_batch(paths, side)
    if f1 or f2 or not np.array_equal(one, two):
        raise AssertionError(f"native decoder: failures {f1} / {f2}, or two runs differ")
    if not np.array_equal(out["native"][0], one):
        raise AssertionError("ClipDataset's native route differs from the decoder's batch")
    pil_small = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (resize_to, resize_to), Image.BILINEAR)) for p in paths])
    pairs = {"images": (out["native"][0], out["pil"][0]),
             "segmaps": (out["native"][1], out["pil"][1]),
             f"images_{resize_to}": (native.decode_resize_batch(paths, resize_to)[0], pil_small)}
    diffs = {}
    for name, (a, b) in pairs.items():
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        diffs[name] = {"mean": float(d.mean()), "max": int(d.max())}
    res["diff_vs_pil"] = diffs
    print(f"completion: native decoder on {n} {side}-px JPEG frames + segmaps: two runs equal "
          "bit for bit; |native - PIL| mean / max: "
          + ", ".join(f"{k} {v['mean']:.4f} / {v['max']}" for k, v in diffs.items())
          + f"; ClipDataset.frames frames/s (best of 2, in turns): native "
          f"{res['frames_per_s']['native']:.1f} ({os.cpu_count()} threads), PIL "
          f"{res['frames_per_s']['pil']:.1f} (1 thread) {where}")
    return res


def phase_completion(workdir: str, smi: str, device: str = "cuda", cfg=None, head_cfg=None,
                     size: int = 224, mstcn_cfg=None, frames: int = COMPLETION_FRAMES,
                     decode_frames: int = DECODE_FRAMES, decode_side: int = DECODE_SIDE) -> dict:
    """Phase 16, the modules the port took last, on ``device`` against the
    CPU in fp32 with TF32 off: (a) the native frame decoder
    (``_decoder_check``); (b) ``capture_attention`` at b3, B = 2: every
    block's map within rel L2 ``COMPLETION_ATTN_BOUND``; (c)
    ``DualTowerMSTCN`` and ``HiddenFeatureMSTCN`` at ``MSTCNConfig()`` on a
    ``frames``-frame video and ``Adaptor`` in both modes, max abs within
    ``COMPLETION_ABS_BOUND``; (d) ``resize_bilinear`` (250 -> 224, 200 ->
    250) within the same bound and ``rotate`` bit for bit; (e) ``cli
    evaluate --vis`` on phase 6's ground-truth and predicted txts where
    matplotlib imports (one PNG per video). ``cfg``, ``head_cfg``, ``size``,
    ``mstcn_cfg`` and the counts size it down for a rehearsal on the CPU."""
    from surgical_tpu_torch import cli
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, MSTCNConfig
    from surgical_tpu_torch.data import transforms
    from surgical_tpu_torch.eval.visualize import capture_attention
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.mstcn import DualTowerMSTCN, HiddenFeatureMSTCN
    from surgical_tpu_torch.models.transsv import Adaptor

    t0 = time.perf_counter()
    cfg, head_cfg = cfg or BackboneConfig(), head_cfg or HeadConfig()
    mstcn_cfg = mstcn_cfg or MSTCNConfig()
    rng = np.random.default_rng(SEED + 16)
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    res = {"decoder": _decoder_check(workdir, smi, decode_frames, decode_side, size, rng)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        # (b) attention capture at b3
        t = time.perf_counter()
        cpu_model = MiTEVP(cfg, head_cfg, seed=SEED + 16, device="cpu")
        model = copy.deepcopy(cpu_model).to(device)
        x = [rng.standard_normal((2, size, size, c)).astype(np.float32) for c in (3, 3, 2)]
        want_out, want = capture_attention(cpu_model, *x)
        got_out, got = capture_attention(model, *x)
        sync()
        if sorted(got) != sorted(want) or len(got) != sum(cfg.depths):
            raise AssertionError(f"capture_attention: {len(got)} maps, names {sorted(got)[:3]}...")
        attn_err = {k: _rel_l2(torch.from_numpy(got[k]), torch.from_numpy(want[k]))
                    for k in want}
        out_err = max(_rel_l2(g, w) for g, w in zip(got_out, want_out))
        worst = max(attn_err, key=attn_err.get)
        print(f"completion: capture_attention at {cfg.variant}, B = 2, {size} px, fp32 on "
              f"{device} vs the CPU: {len(got)} maps, worst rel L2 {attn_err[worst]:.3e} "
              f"({worst}; bound {COMPLETION_ATTN_BOUND}), outputs {out_err:.3e}, "
              f"{time.perf_counter() - t:.2f} s")
        if not (attn_err[worst] <= COMPLETION_ATTN_BOUND and out_err <= COMPLETION_ATTN_BOUND):
            raise AssertionError("capture_attention on the card disagrees with the CPU")
        res["capture_attention"] = {"maps": len(got), "worst_rel_l2": attn_err[worst],
                                    "outputs_rel_l2": out_err}

        # (c) the three classes
        t = time.perf_counter()
        feats = torch.from_numpy(rng.standard_normal((1, frames, mstcn_cfg.f_dim))
                                 .astype(np.float32))
        lt = torch.from_numpy(rng.standard_normal((2, frames, 64)).astype(np.float32))
        win = torch.from_numpy(rng.standard_normal((2, frames, 30, 14)).astype(np.float32))
        cases = {
            "DualTowerMSTCN": (DualTowerMSTCN(mstcn_cfg, seed=SEED + 17, device="cpu"),
                               (feats,), {}),
            "HiddenFeatureMSTCN": (HiddenFeatureMSTCN(mstcn_cfg, seed=SEED + 18, device="cpu"),
                                   (feats,), {}),
            "Adaptor lt_mode": (Adaptor(64, seed=SEED + 19, device="cpu"), tuple(lt), {}),
            "Adaptor window": (Adaptor(30 * 14, seed=SEED + 20, device="cpu"), tuple(win),
                               {"lt_mode": False}),
        }
        errs = {}
        for name, (m, args, kw) in cases.items():
            with torch.no_grad():
                want = m(*args, **kw)
                got = copy.deepcopy(m).to(device)(*(a.to(device) for a in args), **kw)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            if [g.shape for g in got] != [w.shape for w in want] or not all(
                    torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{name}: shapes {[tuple(g.shape) for g in got]} "
                                     "or not finite")
            errs[name] = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        print(f"completion: {', '.join(cases)} on {device} vs the CPU ({frames} frames, "
              f"MSTCNConfig(f_maps={mstcn_cfg.f_maps}, layers={mstcn_cfg.layers}, "
              f"stages={mstcn_cfg.stages})): max abs "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bound {COMPLETION_ABS_BOUND}), {time.perf_counter() - t:.2f} s")
        if not max(errs.values()) <= COMPLETION_ABS_BOUND:
            raise AssertionError("a temporal class on the card disagrees with the CPU")
        res["classes_max_abs"] = errs

        # (d) the transforms
        resize_err = {}
        for src, dst in ((250, 224), (200, 250)):
            clip = torch.from_numpy(rng.uniform(0, 1, (3, src, src, 3)).astype(np.float32))
            want = transforms.resize_bilinear(clip, dst)
            got = transforms.resize_bilinear(clip.to(device), dst)
            resize_err[f"{src}->{dst}"] = (got.cpu() - want).abs().max().item()
        flow = torch.from_numpy(rng.standard_normal((2, size, size, 2)).astype(np.float32))
        rotate_equal = all(
            torch.equal(transforms.rotate(flow.to(device), torch.tensor(float(a)), True).cpu(),
                        transforms.rotate(flow, torch.tensor(float(a)), True))
            for a in range(-5, 6))
        print(f"completion: resize_bilinear on {device} vs the CPU max abs "
              + ", ".join(f"{k} {v:.3e}" for k, v in resize_err.items())
              + f" (bound {COMPLETION_ABS_BOUND}); rotate at -5..5 degrees with vectors equal "
              f"bit for bit: {rotate_equal}")
        if not (max(resize_err.values()) <= COMPLETION_ABS_BOUND and rotate_equal):
            raise AssertionError("the transforms on the card disagree with the CPU")
        res["resize_max_abs"], res["rotate_equal"] = resize_err, rotate_equal
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # (e) evaluate --vis on phase 6's txts
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("completion: vis: not run: matplotlib not importable")
        res["vis_pngs"] = None
    else:
        gt, pred = os.path.join(workdir, "gt"), os.path.join(workdir, "temporal", "output", "Test")
        vids = sorted(int(f[5:7]) for f in os.listdir(pred) if f.endswith("-phase.txt"))
        vis = os.path.join(workdir, "vis")
        if cli.main(["evaluate", "--gt", gt, "--pred", pred, "--first", str(vids[0]),
                     "--last", str(vids[-1]), "--vis", vis]) != 0:
            raise AssertionError("cli evaluate --vis failed")
        pngs = sorted(f for f in os.listdir(vis) if f.endswith("_vis.png"))
        if pngs != [f"video{v:02d}_vis.png" for v in vids]:
            raise AssertionError(f"evaluate --vis wrote {pngs} for videos {vids}")
        print(f"completion: cli evaluate --vis wrote {len(pngs)} ribbon PNGs ({', '.join(pngs)})")
        res["vis_pngs"] = len(pngs)
    res["seconds"] = time.perf_counter() - t0
    print(f"completion: phase 16 in {res['seconds']:.2f} s")
    return res


def _scan_width_check(rng, N, D, T) -> dict:
    """The scan's forward and backward at (d_state N, d_inner D) against
    their plain versions (SCAN_BOUNDS, SCAN_BWD_BOUNDS), each wrapper's
    launches counted over one call of each; kernel, plain and bound times."""
    from surgical_tpu_torch.kernels import selective_scan as ss

    args = scan_inputs(rng, 1, T, D, N)
    dy = torch.from_numpy(rng.standard_normal((1, T, D)).astype(np.float32)).cuda()
    torch.cuda.synchronize()
    ss.reset_launches()
    y, states = ss.selective_scan_forward(*args, states=True)
    grads = ss.selective_scan_backward(*args, dy, states)
    torch.cuda.synchronize()
    launches = {"forward": ss.selective_scan.launches,
                "backward": ss.selective_scan_backward.launches}
    want_launches = {"forward": 1, "backward": 2 if ss.kernel_state(N) == 128 else 1}
    shape = f"[Bt=1, T={T}, D={D}, N={N}]"
    width = ss.kernel_state(N)
    print(f"widths scan {shape}: state width {width}, backward cluster layout "
          f"{ss.backward_layout(-(-D // 4) * 4)} (CTAs per cluster, channel groups), launches "
          f"{launches} (expected {want_launches})")
    if launches != want_launches:
        raise AssertionError(f"selective_scan {shape}: launches {launches}")
    want = ss.selective_scan_plain(*args)
    rel, mx, scale = _errors(f"scan {shape}", y, want)
    ok = rel <= SCAN_BOUNDS[0] and mx <= SCAN_BOUNDS[1]
    print(f"check scan {shape}: rel_l2 {rel:.3e} (bound {SCAN_BOUNDS[0]}) max_abs {mx:.3e} "
          f"(bound {SCAN_BOUNDS[1]}) max|plain| {scale:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"selective_scan {shape}: kernel disagrees with its plain version")
    worst_rel, worst_abs = 0.0, 0.0
    for name, g, w in zip(SCAN_GRADS, grads, ss.selective_scan_plain_backward(*args, dy)):
        rel_g, mx_g, scale_g = _errors(f"scan d{name} {shape}", g, w)
        ok = rel_g <= SCAN_BWD_BOUNDS[0] and mx_g <= SCAN_BWD_BOUNDS[1] * scale_g
        worst_rel, worst_abs = max(worst_rel, rel_g), max(worst_abs, mx_g)
        print(f"check scan backward d{name} {shape} vs plain: rel_l2 {rel_g:.3e} (bound "
              f"{SCAN_BWD_BOUNDS[0]}) max_abs {mx_g:.3e} (bound {SCAN_BWD_BOUNDS[1]} x "
              f"{scale_g:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"selective_scan_backward d{name} {shape} disagrees")
    del grads, want
    ms = time_ms(lambda: ss.selective_scan(*args))
    plain_ms = time_ms(lambda: ss.selective_scan_plain(*args), reps=3)
    bwd_ms = time_ms(lambda: ss.selective_scan_backward(*args, dy, states))
    bwd_plain_ms = time_ms(lambda: ss.selective_scan_plain_backward(*args, dy), reps=3)
    nbytes, op_s = scan_work(1, T, D, N)
    bms, by = bound_ms(nbytes, op_s)
    nbytes_b, op_b = scan_bwd_work(1, T, D, N)
    bms_b, by_b = bound_ms(nbytes_b, op_b)
    print(f"time scan {shape}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bms:.4f} ms "
          f"({by}) | backward kernel {bwd_ms:.4f} ms plain {bwd_plain_ms:.4f} ms bound "
          f"{bms_b:.4f} ms ({by_b})")
    return {"shape": shape, "N": N, "D": D, "T": T, "state_width": width,
            "launches": launches, "rel_l2": rel, "max_abs_err": mx, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bwd": {"rel_l2": worst_rel, "max_abs_err": worst_abs, "ms": bwd_ms,
                    "plain_ms": bwd_plain_ms, "bound_ms": bms_b, "bound_by": by_b}}


def phase_widths(workdir: str) -> dict:
    """Phase 17: the serving kernels at head width 32 (MiT-b0), b0 extraction
    and the b0 session on them, the scan at WIDTH_SCAN, and a refiner with
    LayerNorms and FFN biases away from identity (the constants above)."""
    import surgical_tpu_torch.models.mit_fused as mf
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, RefinerConfig
    from surgical_tpu_torch.kernels import mit_block as mb
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.models.transsv import RefinementTransformer
    from surgical_tpu_torch.serving.online import OnlineRefiner
    from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 40)
    res = {"head_dims": list(mb.SERVING_HEAD_DIMS), "block": []}
    for stage, C, heads, side, sr in B0_STAGES:
        w = _block_weights(rng, C, 4 * C)
        for b in (CHECK_B, BATCH):
            res["block"].append(_block_check(rng, w, stage, heads, side, sr, b,
                                             plain=b == CHECK_B, tag="b0 "))
    C, heads, side, depth, Cb, C4 = B0_STAGE4
    sw = _stage_weights(rng, C, depth, Cb, C4)
    res["stage"] = [_stage_check(rng, sw, heads, side, b, plain=b == CHECK_B, tag="b0 ")
                    for b in (CHECK_B, BATCH)]

    # b0 extraction: one BATCH-frame wire batch on the kernels, then the same
    # batch through the kernels' plain versions
    cfg = BackboneConfig.preset("b0")
    backbone = MiTEVP(cfg, HeadConfig(), seed=SEED + 41, device="cuda")
    batch = (rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8),
             rng.integers(0, 256, (BATCH, 224, 224, 1), dtype=np.uint8),
             rng.standard_normal((BATCH, 224, 224, 2), dtype=np.float32).astype(np.float16))
    feature_fn = make_raw_feature_fn(backbone)
    feature_fn(*batch)  # warm-up
    torch.cuda.synchronize()
    mb.reset_launches()
    feats, st = extract_features(feature_fn, iter([batch]), BATCH, HeadConfig().embedding_dim,
                                 BATCH)
    torch.cuda.synchronize()
    launches = {"mit_block_forward": mb.fused_mit_block.launches,
                "mit_stage_forward": mb.fused_mit_stage.launches}
    print(f"widths b0 extraction: {BATCH} frames at {st['fps']:.1f} frames/s, launches per "
          f"batch {launches} (expected {B0_BATCH_LAUNCHES})")
    if launches != B0_BATCH_LAUNCHES:
        raise AssertionError("b0 extraction did not launch the kernels as expected")
    saved = (mf.fused_mit_block, mf.fused_mit_stage)
    mf.fused_mit_block, mf.fused_mit_stage = mb.fused_mit_block_plain, mb.fused_mit_stage_plain
    try:
        plain = feature_fn(*batch).float()
    finally:
        mf.fused_mit_block, mf.fused_mit_stage = saved
    cos = torch.nn.functional.cosine_similarity(torch.tensor(feats, device="cuda"), plain,
                                                dim=-1)
    print(f"widths b0 extraction: per-frame cosine kernel vs plain features min "
          f"{cos.min().item():.6f} median {cos.median().item():.6f} (bound {COSINE_BOUND})")
    if not np.isfinite(feats).all() or cos.min().item() < COSINE_BOUND:
        raise AssertionError("b0 kernel-path features disagree with the plain path")
    res["extraction"] = {"launches": launches, "fps": st["fps"], "cos_min": cos.min().item()}
    del backbone, feature_fn, plain

    session = phase_online_session(cfg=cfg, frames=B0_SESSION_FRAMES,
                                   blocks=B0_SESSION_BLOCKS)
    res["session"] = {name: {"launches_per_frame": {k: v // B0_SESSION_FRAMES
                                                    for k, v in row["launches"].items()},
                             "ms_per_frame": row["ms_per_frame"]}
                      for name, row in session.items()}

    res["scan"] = [_scan_width_check(rng, N, D, WIDTH_SCAN_T) for N, D in WIDTH_SCAN]

    # the refiner with JAX's parameter set, away from its init
    refiner = RefinementTransformer(RefinerConfig(f_dim=2048), seed=SEED + 42, device="cpu")
    with torch.no_grad():
        moved = [n for n, p in refiner.named_parameters() if n.endswith(REFINER_LN_BIAS)]
        for n, p in refiner.named_parameters():
            if n in moved:
                p.add_(torch.from_numpy(0.2 * rng.standard_normal(p.shape).astype(np.float32)))
    card = copy.deepcopy(refiner).to("cuda")
    g = torch.from_numpy(rng.standard_normal((REFINER_T, 14)).astype(np.float32))
    lfb = torch.from_numpy(rng.standard_normal((REFINER_T, 2048)).astype(np.float32))
    with torch.no_grad():
        want, got = refiner(g, lfb), card(g.cuda(), lfb.cuda())
    stream = OnlineRefiner(card).run(g[:REFINER_STREAM_T].cuda(), lfb[:REFINER_STREAM_T].cuda())
    err = (got.cpu() - want).abs().max().item()
    err_stream = (stream - got[:REFINER_STREAM_T]).abs().max().item()
    print(f"widths refiner: {len(moved)} LayerNorm / FFN-bias tensors moved from identity and "
          f"zero; card vs CPU max abs {err:.3e}, streamed vs offline on the card "
          f"({REFINER_STREAM_T} frames) {err_stream:.3e} (bound {SESSION_LOGIT_BOUND})")
    if not torch.isfinite(got).all() or max(err, err_stream) > SESSION_LOGIT_BOUND:
        raise AssertionError("the refiner with trained LayerNorms and biases disagrees")
    res["refiner"] = {"moved_tensors": len(moved), "card_vs_cpu": err, "stream_vs_offline":
                      err_stream}
    res["seconds"] = time.perf_counter() - t0
    print(f"widths: phase 17 in {res['seconds']:.2f} s")
    return res


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
        ses = phase_online_session()
        tp = phase_temporal(workdir, sl)
        tt = phase_temporal_train(workdir)
        tr = phase_train(workdir)
        phase_flax_graph(workdir, tr["caches"])
        rf = phase_raft(workdir)
        cl = phase_extract_cli(workdir)
        ex = phase_export(workdir)
        q8 = phase_int8()
        mr = phase_multirank(workdir, cl)
        # phase 16 reads phase 6's txts, so it runs before the work dir goes
        done = phase_completion(workdir, smi)
        wd = phase_widths(workdir)
    blk, stg, pk = checks["block"], checks["stage"], checks["packed2"]

    def widths_row(rows, name):  # a serving kernel's b0 numbers: CHECK_B and BATCH sums
        at = lambda b: [r for r in rows if r["B"] == b]
        return {"ms": summed(at(CHECK_B), "ms"), "plain_ms": summed(at(CHECK_B), "plain_ms"),
                "bound_ms": summed(at(CHECK_B), "bound_ms"),
                f"ms_b{BATCH}": summed(at(BATCH), "ms"),
                f"bound_ms_b{BATCH}": summed(at(BATCH), "bound_ms"),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "launches_per_batch": wd["extraction"]["launches"][name],
                "launches_per_frame": wd["session"]["mstcn+refiner"]["launches_per_frame"][name],
                "shapes": rows}

    blk_main, stg_main = checks["block_main"], checks["stage_main"]
    blk_b1 = [r for r in checks["block_session"] if r["B"] == 1]
    main_scan = [r for r in scan if r["shape"].startswith("[Bt=1,") and r["T"] in TEST_LENGTHS]
    summed = lambda rows, key: sum(r[key] for r in rows)
    # launches counted through the ops in the export phase's artifact runs
    ex_launches = {k: sum((r or {}).get(k, 0) for r in ex["launches"].values())
                   for k in ("mit_block_forward", "mit_block_packed2_forward",
                             "mit_stage_forward")}
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
         "launches_online_session": ses["mstcn+refiner"]["launches"]["mit_block_forward"],
         "launches_export": ex_launches["mit_block_forward"],
         "launches_int8": q8["launches"]["mit_block_forward"],
         "launches_multirank": mr["launches_per_rank"]["mit_block_forward"],
         "ms_b1": summed(blk_b1, "ms"), "plain_ms_b1": summed(blk_b1, "plain_ms"),
         "bound_ms_b1": summed(blk_b1, "bound_ms"),
         "max_abs_err_b1": max(r["max_abs_err"] for r in blk_b1),
         "head_dims": wd["head_dims"], "b0": widths_row(wd["block"], "mit_block_forward"),
         "shapes": blk + blk_main + checks["block_session"]},
        {"name": "mit_block_packed2_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:801",
         "launches": sl["route_launches"]["mit_block_packed2_forward"],
         "launches_export": ex_launches["mit_block_packed2_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in pk),
         "ms": pk[1]["ms"], "plain_ms": pk[1]["plain_ms"], "bound_ms": pk[1]["bound_ms"],
         "bound_by": pk[1]["bound_by"], "library_ms": None,
         f"ms_b{BATCH}": pk[-1]["ms"], f"bound_ms_b{BATCH}": pk[-1]["bound_ms"],
         f"block_ms_b{BATCH}": pk[-1]["block_ms"], "block_ms": pk[1]["block_ms"], "shapes": pk},
        {"name": "mit_stage_forward", "route": "cuda", "source": SOURCE,
         "replaces": "surgical_tpu/kernels/mit_block.py:1202",
         "launches": sl["launches"]["mit_stage_forward"],
         "launches_export": ex_launches["mit_stage_forward"],
         "launches_int8": q8["launches"]["mit_stage_forward"],
         "launches_multirank": mr["launches_per_rank"]["mit_stage_forward"],
         "max_abs_err": stg["max_abs_err"], "ms": stg["ms"], "plain_ms": stg["plain_ms"],
         "bound_ms": stg["bound_ms"], "bound_by": stg["bound_by"], "library_ms": None,
         f"ms_b{BATCH}": stg_main["ms"], f"bound_ms_b{BATCH}": stg_main["bound_ms"],
         f"max_abs_err_b{BATCH}": stg_main["max_abs_err"], "hgmma": n_hgmma,
         "head_dims": wd["head_dims"], "b0": widths_row(wd["stage"], "mit_stage_forward"),
         "shapes": [stg, stg_main]},
        {"name": "selective_scan_forward", "route": "cuda", "source": SCAN_SOURCE,
         "replaces": "surgical_tpu/kernels/selective_scan.py:130",
         "launches": tp["launches"],
         "launches_multirank": mr["launches_per_rank"]["selective_scan_forward"],
         "max_abs_err": max(r["max_abs_err"] for r in scan),
         "ms": summed(main_scan, "ms"), "plain_ms": summed(main_scan, "plain_ms"),
         "bound_ms": summed(main_scan, "bound_ms"), "bound_by": by(main_scan),
         "library_ms": None, "device_ops_per_call": max(r["device_ops"] for r in scan),
         "d_states": [r["N"] for r in wd["scan"]], "d_inners": [r["D"] for r in wd["scan"]],
         "widths": [{"launches": r["launches"]["forward"],
                     **{k: r[k] for k in ("shape", "state_width", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by")}}
                    for r in wd["scan"]],
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
        "widths": [{"shape": r["shape"], "launches": r["launches"]["backward"], **r["bwd"]}
                   for r in wd["scan"]],
        "shapes": scan_bwd["shapes"]})
    for name, line, key in (("mit_block_train_forward", 1645, "forward"),
                            ("mit_block_train_mlp_backward", 1695, "mlp_backward"),
                            ("mit_block_train_attn_backward", 1729, "attn_backward")):
        rows, rows_main = train_checks[CHECK_B][key], train_checks[TRAIN_B][key]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"surgical_tpu/kernels/mit_block.py:{line}",
            "launches": tr["launches"][name],
            "launches_multirank": mr["launches_per_rank"][name],
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
    session = {"frames": SESSION_FRAMES, "launches_per_frame": {
        k: v // SESSION_FRAMES for k, v in ses["mstcn+refiner"]["launches"].items()},
        **{name: {k: row[k] for k in ("ms_per_frame", "feature_ms", "temporal_ms", "device_ops")}
           for name, row in ses.items()}}
    raft = {k: rf[k] for k in ("pairs_per_s", "ms_per_pair", "iters", "size", "padded",
                               "device_ops_per_pair")}
    multirank = {"backend": mr["backend"], "seconds": mr["seconds"],
                 "cli_launches_per_rank": mr["cli_launches"]}
    widths = {"b0_extraction": wd["extraction"], "b0_session": wd["session"],
              "refiner": wd["refiner"], "seconds": wd["seconds"]}
    print(json.dumps({"kernels": kernels, "online_session": session, "raft": raft,
                      "multirank": multirank, "completion": done, "widths": widths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
