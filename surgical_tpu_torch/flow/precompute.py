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

Beyond the copy: a flow_fn that carries ``batched = True``
(``models/raft.py::make_flow_fn``) takes up to ``batch_size`` pending pairs
of one video in one call, unpadded (it pads on the device and crops). A frame
that fails to load fails the pairs that read it, never their batch; a frame
read by two neighbouring pairs is decoded once. Spans ``flow.load`` and
``flow.save`` (``utils/trace.py``) mark each pair's decode and publish.
"""

from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from surgical_tpu_torch.utils.trace import span

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
    """Drives a flow_fn over a frame library, writing per-frame .npy files.
    flow_fn(frame1 [H,W,3], frame2) -> [H,W,2] on pairs padded here to
    multiples of 8, or, where it carries ``batched = True``, flow_fn(frames1
    [B,H,W,3], frames2) -> [B,H,W,2] on unpadded pairs, up to
    ``batch_size`` at a time."""

    flow_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
    out_root: str
    log_path: str | None = None
    median_filter: bool = False
    stats: dict = field(default_factory=lambda: {"done": 0, "skipped": 0, "failed": 0})
    batch_size: int = 1

    def _log(self, msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(line + "\n")

    def _fail(self, video, frame: int) -> None:
        self.stats["failed"] += 1
        self._log(f"video {video} frame {frame} FAILED:\n{traceback.format_exc()}")

    def out_path(self, video: str | int, frame: int) -> str:
        return os.path.join(self.out_root, str(video), f"{frame}.npy")

    def compute_pairs(self, firsts: Sequence[np.ndarray],
                      seconds: Sequence[np.ndarray]) -> list[np.ndarray]:
        """The flows [H, W, 2] float32 of the pairs (firsts[i], seconds[i]),
        frames of one shape."""
        if getattr(self.flow_fn, "batched", False):
            flows = list(np.asarray(self.flow_fn(np.stack(firsts), np.stack(seconds)),
                                    dtype=np.float32))
        else:
            flows = []
            for frame1, frame2 in zip(firsts, seconds):
                p1, (H, W) = pad_to_multiple_hw(frame1)
                p2, _ = pad_to_multiple_hw(frame2)
                flows.append(np.asarray(self.flow_fn(p1, p2), dtype=np.float32)[:H, :W])
        if self.median_filter:
            from scipy.ndimage import median_filter as mf  # optional dep

            flows = [np.stack([mf(f[..., i], size=3) for i in range(2)], axis=-1) for f in flows]
        return flows

    def compute_pair(self, frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
        return self.compute_pairs([frame1], [frame2])[0]

    def _publish(self, video, batch: list) -> None:
        """Computes the pending pairs [(frame, frame1, frame2)] in one call
        and writes each file atomically; a failure fails the pairs it
        touches, each logged with the traceback."""
        try:
            flows = self.compute_pairs([b[1] for b in batch], [b[2] for b in batch])
        except Exception:
            for n, *_ in batch:
                self._fail(video, n)
            return
        for (n, *_), flow in zip(batch, flows):
            out = self.out_path(video, n)
            tmp = out + ".tmp.npy"
            try:
                with span("flow.save"):
                    np.save(tmp, flow)
                    os.replace(tmp, out)  # atomic publish: resume-safe
                self.stats["done"] += 1
            except Exception:
                self._fail(video, n)
                if os.path.exists(tmp):
                    os.remove(tmp)

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
        size = self.batch_size if getattr(self.flow_fn, "batched", False) else 1
        last: dict = {}  # the last frame decoded: the next pair's first

        def load(m):
            if m not in last:
                last.clear()
                last[m] = load_frame(m)
            return last[m]

        batch = []
        for n in frame_numbers:
            if n + interval not in available:
                continue  # no successor (last frame): consumers use zero flow
            if os.path.exists(self.out_path(video, n)):
                self.stats["skipped"] += 1
                continue
            try:
                with span("flow.load"):
                    frame1, frame2 = load(n), load(n + interval)
                if frame1.shape != frame2.shape:
                    raise ValueError(f"frames {n} and {n + interval} differ in shape: "
                                     f"{frame1.shape}, {frame2.shape}")
            except Exception:
                self._fail(video, n)
                continue
            if batch and batch[0][1].shape != frame1.shape:
                self._publish(video, batch)  # one shape per call
                batch = []
            batch.append((n, frame1, frame2))
            if len(batch) == size:
                self._publish(video, batch)
                batch = []
        if batch:
            self._publish(video, batch)
        self._log(f"video {video}: {self.stats}")


def load_flow_or_zero(path: str, shape_hw: tuple[int, int]) -> np.ndarray:
    """Dataset-side fallback for missing flow (data_process.py:424-429)."""
    if os.path.exists(path):
        return np.load(path)
    return np.zeros((*shape_hw, 2), dtype=np.float32)
