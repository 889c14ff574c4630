"""Whole-video supervision for the temporal stage.

Port of the dataset half of ``surgical_tpu/train/temporal.py``; the trainer
is a later port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass
class VideoDataset:
    """Per-split whole-video supervision: contiguous frame rows per video."""

    features: Any  # FeatureStore-like: .video(i) -> [T, D]
    labels_phase: np.ndarray  # [N] int
    labels_ant: np.ndarray  # [N, num_phases] float
    lengths: np.ndarray  # [num_videos]
    starts: np.ndarray  # [num_videos]

    @property
    def num_videos(self) -> int:
        return len(self.lengths)

    def video_arrays(self, i: int):
        s, L = int(self.starts[i]), int(self.lengths[i])
        return (
            np.asarray(self.features.video(i), dtype=np.float32),
            self.labels_phase[s : s + L].astype(np.int32),
            self.labels_ant[s : s + L].astype(np.float32),
        )
