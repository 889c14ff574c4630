"""Tiny configurations and workloads for the CPU tests: the cells' own
files with the widths, depths, batches and lengths cut to what a CPU test
holds, and the harness's checks kept as they are."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core, files  # noqa: E402

CELLS = ("b3-mstcn.extract", "b3-mstcn.train", "b0-mamba.stream", "b0-mamba.video")


def tiny_config(name: str) -> dict:
    c = copy.deepcopy(files.config(name))
    bb = c["backbone"]["config"]
    bb.update(variant="tiny", img_size=64, embed_dims=[16, 32, 48, 64], num_heads=[1, 2, 3, 4],
              depths=[1, 2, 1, 1])
    c["backbone"]["head"].update(embedding_dim=64, hidden=32)
    t = c["temporal"]["config"]
    if c["temporal"]["kind"] == "mamba":
        t.update(layers=2, d_model=16, d_state=8, f_dim=64)
    else:
        t.update(layers=3, f_maps=16, f_dim=64)
    c["refiner"]["config"].update(f_dim=64, f_maps=16)
    return c


def tiny_workload(name: str) -> dict:
    w = copy.deepcopy(files.workload(name))
    p = w["traffic"]
    kind = p["kind"]
    if kind == "extract":
        p.update(batch=8, size=64, pool_batches=2, batches_per_unit=2, check_batches=2)
    elif kind == "train":
        p.update(batch=4, resize=72, crop=64, pool_batches=3)
    elif kind == "stream":
        p.update(size=64, pool_frames=6, warmup_frames=1, warmup_seconds=0.0,
                 video_lengths=[3, 5])
    elif kind == "video":
        p.update(video_lengths=[20, 33, 47], check_videos=2)
    w["trace_units"] = 0
    return w


def context(name: str, seed: int = 2**31 + 11, **kw) -> core.Context:
    w = tiny_workload(name)
    return core.Context(seed, torch.device("cpu"), tiny_config(w["config"]), w, **kw)


def run(name: str, units: int = 3, traffic_mod=None, **kw) -> dict:
    """A run of the cell at tiny size on the CPU, ``units`` units long."""
    ctx = context(name, **kw)
    traffic_mod = traffic_mod or files.traffic(ctx.params["kind"])
    return core.run_cell(ctx, 0.0, 0.0, traffic_mod=traffic_mod, max_units=units)
