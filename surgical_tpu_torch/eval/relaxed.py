"""MICCAI-relaxed Cholec80 phase evaluation.

Implements the official Cholec80 ``Evaluate.m``/``Main.m`` semantics that the
reference ports in eval_and_vis.py:35-161,247-279: a ``tolerance``-frame
boundary relaxation where specific prediction/GT phase-index differences are
forgiven at the head/tail of every GT phase segment, per-phase relaxed
jaccard/precision/recall, relaxed accuracy, clamping at 100, and the
two-level (video-mean-then-phase-mean) nanmean aggregation.

Phase-group rules (MATLAB phases 1-7 = python 0-6):
- phases 3, 4 (GallbladderPackaging, CleaningCoagulation): head forgives
  diff == -1; tail forgives diff in {+1, +2}
- phases 5, 6 (CleaningCoagulation... GallbladderRetraction): head forgives
  diff in {-1, -2}; tail forgives {+1, +2}
- phases 0, 1, 2: head forgives -1; tail forgives +1

The port's own copy of ``surgical_tpu/eval/relaxed.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

NUM_PHASES = 7
TOLERANCE = 10


def _segments(mask: np.ndarray):
    """(start, end) half-open spans of True runs."""
    padded = np.pad(mask.astype(np.int8), (1, 1))
    d = np.diff(padded)
    return zip(np.where(d == 1)[0], np.where(d == -1)[0])


def relaxed_diff(
    y_gt: np.ndarray,
    y_pred: np.ndarray,
    num_phases: int = NUM_PHASES,
    tolerance: int = TOLERANCE,
) -> np.ndarray:
    """Return the boundary-relaxed difference array (0 == relaxed-correct)."""
    y_gt = np.asarray(y_gt, dtype=int)
    y_pred = np.asarray(y_pred, dtype=int)
    diff = y_pred - y_gt
    updated = diff.copy()

    for phase in range(num_phases):
        is_phase = y_gt == phase
        if not np.any(is_phase):
            continue
        if phase in (3, 4):
            head_ok = (-1,)
            tail_ok = (1, 2)
        elif phase in (5, 6):
            head_ok = (-1, -2)
            tail_ok = (1, 2)
        else:
            head_ok = (-1,)
            tail_ok = (1,)
        for start, end in _segments(is_phase):
            t = min(tolerance, end - start)
            head = diff[start : start + t]
            tail = diff[end - t : end]
            updated[start : start + t][np.isin(head, head_ok)] = 0
            updated[end - t : end][np.isin(tail, tail_ok)] = 0
    return updated


def evaluate_video(
    y_gt: np.ndarray,
    y_pred: np.ndarray,
    num_phases: int = NUM_PHASES,
    tolerance: int = TOLERANCE,
):
    """Relaxed (acc, precision[], recall[], jaccard[]) for one video; phase
    entries are NaN when the phase is absent from GT (eval_and_vis.py:128-131)."""
    y_gt = np.asarray(y_gt, dtype=int)
    y_pred = np.asarray(y_pred, dtype=int)
    updated = relaxed_diff(y_gt, y_pred, num_phases, tolerance)

    prec = np.full(num_phases, np.nan)
    rec = np.full(num_phases, np.nan)
    jacc = np.full(num_phases, np.nan)

    for phase in range(num_phases):
        gt_mask = y_gt == phase
        if not np.any(gt_mask):
            continue
        pred_mask = y_pred == phase
        union = gt_mask | pred_mask
        tp = float(np.sum(updated[union] == 0))
        jacc[phase] = tp / union.sum() * 100
        pred_count = pred_mask.sum()
        gt_count = gt_mask.sum()
        prec[phase] = tp / pred_count * 100 if pred_count > 0 else 0.0
        rec[phase] = tp / gt_count * 100 if gt_count > 0 else 0.0

    acc = float(np.sum(updated == 0)) / len(y_gt) * 100
    return acc, prec, rec, jacc


@dataclass
class RelaxedResult:
    mean_acc: float
    std_acc: float
    mean_prec: float
    std_prec: float
    mean_rec: float
    std_rec: float
    mean_jacc: float
    std_jacc: float
    phase_mean_prec: np.ndarray
    phase_mean_rec: np.ndarray
    phase_mean_jacc: np.ndarray
    phase_std_prec: np.ndarray
    phase_std_rec: np.ndarray
    phase_std_jacc: np.ndarray


def evaluate_videos(
    gts: Sequence[np.ndarray],
    preds: Sequence[np.ndarray],
    num_phases: int = NUM_PHASES,
    tolerance: int = TOLERANCE,
) -> RelaxedResult:
    """Aggregate across videos with the Main.m recipe: clip at 100, nanmean
    over videos per phase, then mean over phases (eval_and_vis.py:247-279)."""
    n = len(gts)
    mat_prec = np.full((n, num_phases), np.nan)
    mat_rec = np.full((n, num_phases), np.nan)
    mat_jacc = np.full((n, num_phases), np.nan)
    accs = []
    for i, (gt, pred) in enumerate(zip(gts, preds)):
        m = min(len(gt), len(pred))
        acc, p, r, j = evaluate_video(gt[:m], pred[:m], num_phases, tolerance)
        accs.append(acc)
        mat_prec[i], mat_rec[i], mat_jacc[i] = p, r, j

    mat_prec = np.clip(mat_prec, 0, 100)
    mat_rec = np.clip(mat_rec, 0, 100)
    mat_jacc = np.clip(mat_jacc, 0, 100)
    accs = np.clip(np.asarray(accs, dtype=float), 0, 100)

    pm_prec = np.nanmean(mat_prec, axis=0)
    pm_rec = np.nanmean(mat_rec, axis=0)
    pm_jacc = np.nanmean(mat_jacc, axis=0)

    return RelaxedResult(
        mean_acc=float(np.mean(accs)),
        std_acc=float(np.std(accs)),
        mean_prec=float(np.mean(pm_prec)),
        std_prec=float(np.std(pm_prec)),
        mean_rec=float(np.mean(pm_rec)),
        std_rec=float(np.std(pm_rec)),
        mean_jacc=float(np.mean(pm_jacc)),
        std_jacc=float(np.std(pm_jacc)),
        phase_mean_prec=pm_prec,
        phase_mean_rec=pm_rec,
        phase_mean_jacc=pm_jacc,
        phase_std_prec=np.nanstd(mat_prec, axis=0),
        phase_std_rec=np.nanstd(mat_rec, axis=0),
        phase_std_jacc=np.nanstd(mat_jacc, axis=0),
    )
