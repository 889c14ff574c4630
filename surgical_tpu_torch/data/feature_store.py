"""Whole-video feature store — the Long-term Feature Bank (LFB).

Replaces the reference's three monolithic pickles of float arrays
(generate_evp_LFB.py:502-520, loaded by tecno.py:80-85) with a memory-mapped
``features.npy`` + ``manifest.json`` holding per-video lengths and split
metadata. Videos are contiguous row-ranges, so ``video(i)`` is a zero-copy
slice; the reference's per-frame Python gather (``get_long_feature``,
tecno.py:64-73) becomes one memmap view.

Reference pickles remain importable/exportable for artifact compatibility.

The port's own copy of ``surgical_tpu/data/feature_store.py``: the same
on-disk format, so either package opens a store the other wrote.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class FeatureStore:
    features: np.ndarray  # [N, D] (possibly memmap)
    lengths: np.ndarray  # [num_videos]
    starts: np.ndarray  # [num_videos]
    meta: dict

    @property
    def num_videos(self) -> int:
        return len(self.lengths)

    @property
    def dim(self) -> int:
        return self.features.shape[1]

    def video(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.features[s : s + int(self.lengths[i])]

    # -- persistence ---------------------------------------------------------
    @classmethod
    def create(
        cls,
        directory: str,
        features: np.ndarray,
        lengths: Sequence[int],
        meta: dict | None = None,
    ) -> "FeatureStore":
        os.makedirs(directory, exist_ok=True)
        lengths = np.asarray(lengths, dtype=np.int64)
        assert int(lengths.sum()) == features.shape[0], (
            f"lengths sum {lengths.sum()} != rows {features.shape[0]}"
        )
        np.save(os.path.join(directory, "features.npy"), np.asarray(features))
        manifest = {
            "lengths": lengths.tolist(),
            "dim": int(features.shape[1]),
            "dtype": str(features.dtype),
            "meta": meta or {},
        }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return cls.open(directory)

    @classmethod
    def open(cls, directory: str, mmap: bool = True) -> "FeatureStore":
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        features = np.load(
            os.path.join(directory, "features.npy"),
            mmap_mode="r" if mmap else None,
        )
        lengths = np.asarray(manifest["lengths"], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        return cls(features=features, lengths=lengths, starts=starts, meta=manifest.get("meta", {}))

    # -- reference-pickle interop ---------------------------------------------
    @classmethod
    def from_reference_pickle(
        cls, pkl_path: str, lengths: Sequence[int], directory: str, meta: dict | None = None
    ) -> "FeatureStore":
        """Import a reference ``evp_LFB_*.pkl`` bank ([N, 2048] ndarray)."""
        with open(pkl_path, "rb") as f:
            features = pickle.load(f)
        return cls.create(directory, np.asarray(features), lengths, meta)

    def to_reference_pickle(self, pkl_path: str) -> None:
        os.makedirs(os.path.dirname(pkl_path) or ".", exist_ok=True)
        with open(pkl_path, "wb") as f:
            pickle.dump(np.asarray(self.features), f)


def bucket_length(T: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= T (avoids an XLA recompile per video length)."""
    for b in buckets:
        if T <= b:
            return b
    raise ValueError(f"video length {T} exceeds largest bucket {buckets[-1]}")


def pad_video(
    x: np.ndarray, target_T: int
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad [T, ...] to [target_T, ...]; returns (padded, mask[target_T])."""
    T = x.shape[0]
    mask = np.zeros((target_T,), dtype=bool)
    mask[:T] = True
    if T == target_T:
        return np.asarray(x), mask
    pad = [(0, target_T - T)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad), mask
