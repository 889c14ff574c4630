"""Refinement-transformer training and end-to-end phase prediction.

Port of ``surgical_tpu/train/refiner.py``:

- ``RefinerTrainer`` (tecno_trans.py): the temporal model (MS-TCN or Mamba)
  is frozen and runs under ``no_grad`` in eval mode (on the card the Mamba
  forward takes the scan kernel's no-grad path); its final stage feeds the
  refiner, trained one video per step on 0.5 * weighted CE + SmoothL1
  (Adam 5e-4 without weight decay in the CLI, tecno_trans.py:190-205).
- ``predict_video`` / ``evaluate`` / ``predict_and_write``
  (trans_SV_output.py): per video LFB -> temporal final stage -> refiner ->
  argmax phases + anticipation, plus the ``video<NN>-phase.txt`` artifacts.

Both models are causal, so each video runs at its true length: the JAX
package's bucket padding exists for XLA compiles.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch

from surgical_tpu_torch.core.config import TrainConfig
from surgical_tpu_torch.eval.predictions import video_txt_name, write_phase_txt
from surgical_tpu_torch.train.losses import refiner_loss
from surgical_tpu_torch.train.optim import build_optimizer
from surgical_tpu_torch.train.temporal import VideoDataset, epoch_metrics
from surgical_tpu_torch.utils.trace import span


@torch.no_grad()
def predict_video(temporal, refiner, lfb: torch.Tensor) -> torch.Tensor:
    """lfb [T, D] -> refined outputs [T, out_features] (phase logits, then
    anticipation). The temporal model's last stage feeds the refiner: MS-TCN
    gives [S, 1, T, out], Mamba [1, 1, T, out]."""
    with span("predict.temporal"):
        g = temporal(lfb[None])[-1, 0]
    with span("predict.refiner"):
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
    preds, ants = [], []
    for i in range(ds.num_videos):
        f, _, _ = ds.video_arrays(i)
        out = predict_fn(torch.tensor(f, device=device)).cpu().numpy()
        preds.append(np.argmax(out[:, :num_phases], axis=-1))
        ants.append(out[:, num_phases:])
    return epoch_metrics(ds, preds, num_phases, horizon, ants), preds, ants


class RefinerTrainer:
    """Trains ``refiner`` in place on the frozen ``temporal`` model's final
    stage, one video per step, on the device of the refiner's parameters."""

    def __init__(self, temporal, refiner, cfg: TrainConfig, num_phases: int = 7):
        self.temporal, self.refiner = temporal, refiner
        self.cfg = cfg
        self.num_phases = num_phases
        self.device = next(refiner.parameters()).device
        self.class_weights = torch.tensor(cfg.class_weights, dtype=torch.float32,
                                          device=self.device)

    def init(self) -> torch.optim.Optimizer:
        """The optimizer over the refiner's parameters only."""
        return build_optimizer(self.cfg.optim, self.refiner.parameters())

    def train_step(self, opt, lfb, labels, ant):
        """One step on one video's tensors (lfb [T, D], labels [T], ant [T,
        P]): (loss, clc, ant, correct) as 0-d tensors."""
        self.temporal.eval()
        with torch.no_grad():
            g = self.temporal(lfb[None])[-1, 0]
        self.refiner.train()
        out = self.refiner(g, lfb)
        total, clc, antl = refiner_loss(out, labels, ant, self.class_weights,
                                        num_phases=self.num_phases)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        with torch.no_grad():
            correct = (out[:, :self.num_phases].argmax(-1) == labels).sum()
        return total.detach(), clc.detach(), antl.detach(), correct

    def train_epoch(self, opt, ds: VideoDataset, epoch: int) -> dict:
        """One pass over ``ds`` in video order: summed loss, frame accuracy and
        seconds, under JAX's keys."""
        t0 = time.time()
        total, correct = 0.0, 0
        for i in range(ds.num_videos):
            f, l, a = (torch.tensor(v, device=self.device) for v in ds.video_arrays(i))
            loss, _, _, corr = self.train_step(opt, f, l.long(), a)
            total += float(loss)
            correct += int(corr)
        return {"train_loss": total, "train_acc": correct / int(ds.lengths.sum()),
                "train_time_s": time.time() - t0}

    def evaluate(self, ds: VideoDataset, horizon: float | None = None,
                 predict_fn: Callable | None = None):
        """(metrics, per-video phase predictions, per-video anticipation) of
        the temporal model + refiner over ``ds``."""
        self.refiner.eval()
        return evaluate(self.temporal, self.refiner, ds,
                        horizon if horizon is not None else self.cfg.horizon,
                        self.num_phases, predict_fn)


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
