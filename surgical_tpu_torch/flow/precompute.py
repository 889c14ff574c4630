"""Resumable optical-flow precompute driver.

The port's copy of ``surgical_tpu/flow/precompute.py`` (numpy only; the port
imports nothing of the JAX package). It rebuilds the reference's RAFT batch
driver (RAFT.py): for every video, compute flow between 1-fps frame n and
frame n+25 (FRAME_INTERVAL=25, RAFT.py:40), pad inputs to a multiple of 8
(InputPadder, :81-83), save ``raft_flow_npy/<video>/<frame>.npy`` float32
(H, W, 2) (:258-259).

Fault-tolerance semantics kept: idempotent/resumable via existing-file skip
(:228-245), atomic publish through ``.tmp.npy`` and ``os.replace``,
per-pair error-continue with the traceback in an append-only progress log
(:152-158, :274-281). The last frame of each video has no successor pair;
like the reference's dataset fallback (data_process.py:424-429) consumers
substitute zero flow for missing files.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

FRAME_INTERVAL = 25


def pad_to_multiple_hw(img: np.ndarray, multiple: int = 8) -> tuple[np.ndarray, tuple[int, int]]:
    """Pad [H, W, C] spatially (bottom/right, edge values) to a multiple;
    returns (padded, original (H, W)) so flow can be cropped back."""
    H, W = img.shape[:2]
    ph = (-H) % multiple
    pw = (-W) % multiple
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return img, (H, W)


@dataclass
class FlowPrecomputeDriver:
    """Drives a flow_fn(frame1 [H,W,3], frame2) -> [H,W,2] over a frame
    library, writing per-frame .npy files."""

    flow_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
    out_root: str
    log_path: str | None = None
    median_filter: bool = False
    stats: dict = field(default_factory=lambda: {"done": 0, "skipped": 0, "failed": 0})

    def _log(self, msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(line + "\n")

    def out_path(self, video: str | int, frame: int) -> str:
        return os.path.join(self.out_root, str(video), f"{frame}.npy")

    def compute_pair(self, frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
        p1, (H, W) = pad_to_multiple_hw(frame1)
        p2, _ = pad_to_multiple_hw(frame2)
        flow = np.asarray(self.flow_fn(p1, p2), dtype=np.float32)[:H, :W]
        if self.median_filter:
            from scipy.ndimage import median_filter as mf  # optional dep

            flow = np.stack([mf(flow[..., i], size=3) for i in range(2)], axis=-1)
        return flow

    def run_video(
        self,
        video: str | int,
        frame_numbers: Sequence[int],
        load_frame: Callable[[int], np.ndarray],
        interval: int = FRAME_INTERVAL,
    ) -> None:
        """frame_numbers: sorted 25-fps frame ids present on disk (the 1-fps
        subsampled set, stride `interval`)."""
        os.makedirs(os.path.join(self.out_root, str(video)), exist_ok=True)
        available = set(frame_numbers)
        for n in frame_numbers:
            if n + interval not in available:
                continue  # no successor (last frame): consumers use zero flow
            out = self.out_path(video, n)
            if os.path.exists(out):
                self.stats["skipped"] += 1
                continue
            try:
                flow = self.compute_pair(load_frame(n), load_frame(n + interval))
                tmp = out + ".tmp.npy"
                np.save(tmp, flow)
                os.replace(tmp, out)  # atomic publish: resume-safe
                self.stats["done"] += 1
            except Exception:
                self.stats["failed"] += 1
                self._log(f"video {video} frame {n} FAILED:\n{traceback.format_exc()}")
        self._log(f"video {video}: {self.stats}")


def load_flow_or_zero(path: str, shape_hw: tuple[int, int]) -> np.ndarray:
    """Dataset-side fallback for missing flow (data_process.py:424-429)."""
    if os.path.exists(path):
        return np.load(path)
    return np.zeros((*shape_hw, 2), dtype=np.float32)
