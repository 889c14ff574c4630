"""Evaluation metrics.

- Anticipation MAE triad (inMAE / pMAE / eMAE) with the exact masking rules
  duplicated across five reference scripts (tecno.py:367-387,
  trans_SV_output.py:366-386, train_evp.py:679-702, ...).
- Macro precision / recall / jaccard equivalent to the sklearn calls in
  tecno.py:394-398 (implemented directly; no sklearn dependency).

These run host-side on numpy (eval aggregation, not a hot path). The port's
own copy of ``surgical_tpu/eval/metrics.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class MAETriad:
    """Accumulates per-(video, phase) MAE instances, mirroring the reference's
    flat ``in_MAE/pMAE/eMAE`` lists that collect one entry per phase per video
    whenever the mask is non-empty (tecno.py:367-387)."""

    horizon: float = 5.0
    in_mae: list = field(default_factory=list)
    p_mae: list = field(default_factory=list)
    e_mae: list = field(default_factory=list)

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        """pred, gt: [T, num_phases] normalized anticipation in [0, 1]."""
        pred = np.asarray(pred, dtype=np.float64).T  # [P, T]
        gt = np.asarray(gt, dtype=np.float64).T
        h = self.horizon
        for y, t in zip(pred, gt):
            inside_horizon = (t > 0.0) & (t < 1.0)
            anticipating = (y > 0.1) & (y < 0.9)
            e_anticipating = (t < 0.1) & (t > 0.0)
            for mask, bucket in (
                (inside_horizon, self.in_mae),
                (anticipating, self.p_mae),
                (e_anticipating, self.e_mae),
            ):
                if np.any(mask):
                    bucket.append(float(np.mean(np.abs(y[mask] * h - t[mask] * h))))

    def result(self) -> dict:
        mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
        return {
            "inMAE": mean(self.in_mae),
            "pMAE": mean(self.p_mae),
            "eMAE": mean(self.e_mae),
        }


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def precision_recall_jaccard(
    y_true: np.ndarray, y_pred: np.ndarray, num_classes: int = 7
) -> dict:
    """sklearn-equivalent macro + per-class precision/recall/jaccard.

    Matches sklearn semantics: macro averages over the classes present in
    y_true ∪ y_pred; a class with zero denominator contributes 0.
    """
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_count = cm.sum(axis=0).astype(np.float64)
    true_count = cm.sum(axis=1).astype(np.float64)
    union = pred_count + true_count - tp

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(true_count > 0, tp / true_count, 0.0)
        jaccard = np.where(union > 0, tp / union, 0.0)

    present = (true_count > 0) | (pred_count > 0)
    macro = lambda v: float(np.mean(v[present])) if np.any(present) else 0.0
    return {
        "precision_macro": macro(precision),
        "recall_macro": macro(recall),
        "jaccard_macro": macro(jaccard),
        "precision_each": precision,
        "recall_each": recall,
        "jaccard_each": jaccard,
    }


def frame_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else float("nan")


def video_accuracy(per_video_acc: Sequence[float]) -> float:
    return float(np.mean(per_video_acc)) if len(per_video_acc) else float("nan")
