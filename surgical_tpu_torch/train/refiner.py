"""End-to-end phase prediction: per video LFB -> temporal model's final stage
-> refinement transformer -> argmax phases + anticipation, plus the
``video<NN>-phase.txt`` artifacts.

Port of the prediction half of ``surgical_tpu/train/refiner.py`` (the
trainer is a later port). Both models are causal, so each video runs at its
true length: the JAX package's bucket padding exists for XLA compiles.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from surgical_tpu_torch.core.config import TrainConfig
from surgical_tpu_torch.eval.metrics import MAETriad, frame_accuracy, precision_recall_jaccard
from surgical_tpu_torch.eval.predictions import video_txt_name, write_phase_txt
from surgical_tpu_torch.train.temporal import VideoDataset


@torch.no_grad()
def predict_video(temporal, refiner, lfb: torch.Tensor) -> torch.Tensor:
    """lfb [T, D] -> refined outputs [T, out_features] (phase logits, then
    anticipation). The temporal model's last stage feeds the refiner: MS-TCN
    gives [S, 1, T, out], Mamba [1, 1, T, out]."""
    g = temporal(lfb[None])[-1, 0]
    return refiner(g, lfb)


def evaluate(temporal, refiner, ds: VideoDataset, horizon: float = TrainConfig.horizon,
             num_phases: int = 7, predict_fn: Callable | None = None):
    """Predict every video of ``ds``; returns (metrics, per-video phase
    predictions, per-video anticipation predictions). ``predict_fn(lfb [T, D])
    -> [T, out]`` replaces the offline composition ``predict_video``: the
    streaming pipeline of ``serving/online.py`` (``cli predict --online``)."""
    device = next(refiner.parameters()).device
    if predict_fn is None:
        predict_fn = lambda lfb: predict_video(temporal, refiner, lfb)
    triad = MAETriad(horizon=horizon)
    per_video_acc, all_p, all_l, preds, ants = [], [], [], [], []
    for i in range(ds.num_videos):
        f, l, a = ds.video_arrays(i)
        out = predict_fn(torch.tensor(f, device=device)).cpu().numpy()
        pred = np.argmax(out[:, :num_phases], axis=-1)
        ant_pred = out[:, num_phases:]
        triad.update(ant_pred, a)
        per_video_acc.append(frame_accuracy(l, pred))
        all_p.append(pred)
        all_l.append(l)
        preds.append(pred)
        ants.append(ant_pred)
    flat_p, flat_l = np.concatenate(all_p), np.concatenate(all_l)
    metrics = {
        "acc_frame": frame_accuracy(flat_l, flat_p),
        "acc_video": float(np.mean(per_video_acc)),
        **triad.result(),
        **{k: v for k, v in precision_recall_jaccard(flat_l, flat_p, num_phases).items()
           if np.isscalar(v)},
    }
    return metrics, preds, ants


def predict_and_write(temporal, refiner, ds: VideoDataset, out_dir: str, video_ids,
                      fps: int = 25, predict_fn: Callable | None = None):
    """Predictions + ``video<NN>-phase.txt`` per video + metrics."""
    metrics, preds, ants = evaluate(temporal, refiner, ds, predict_fn=predict_fn)
    if len(preds) != len(video_ids):
        raise ValueError(f"{len(preds)} videos predicted, {len(video_ids)} ids given")
    os.makedirs(out_dir, exist_ok=True)
    for vid, pred in zip(video_ids, preds):
        write_phase_txt(os.path.join(out_dir, video_txt_name(vid)), pred, fps=fps)
    return metrics, preds, ants
