"""Temporal-stage training (tecno.py): whole videos, per-stage weighted CE +
SmoothL1, AdamW with a global-norm clip of 1.0, ReduceLROnPlateau (max) on
val accuracy, a checkpoint per epoch.

Port of ``surgical_tpu/train/temporal.py`` (``VideoDataset``,
``TemporalTrainer``). The step order is JAX's: videos grouped by
``bucket_length`` in order of first appearance, then cut into batches
(``_make_batches``). A batch of one video runs at its true length, which is
exact because both temporal models are causal and the losses are masked; a
batch of several videos is right-padded to its bucket and carries the mask,
as JAX's ``_collate``. The dropout masks of step ``b`` of epoch ``e`` come
from a generator seeded by (seed, e, b), as JAX folds (e, b) into its key,
so a resumed run draws the masks an uninterrupted one draws. Evaluation
runs each video at its true length in eval mode (no dropout).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from surgical_tpu_torch.core import rng as rnglib
from surgical_tpu_torch.core.config import TrainConfig
from surgical_tpu_torch.data.feature_store import bucket_length, pad_video
from surgical_tpu_torch.eval.metrics import MAETriad, frame_accuracy, precision_recall_jaccard
from surgical_tpu_torch.models.mstcn import DropoutMasks
from surgical_tpu_torch.train.losses import temporal_stage_loss
from surgical_tpu_torch.train.optim import PlateauController, build_optimizer, get_lr, set_lr


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


def dropout_masks(seed: int, epoch: int, batch: int, device) -> DropoutMasks:
    """The dropout masks of one training step: a generator on ``device``
    seeded by (seed, epoch, batch)."""
    return DropoutMasks(rnglib.generator(seed, epoch, batch, purpose="dropout", device=device))


def make_batches(ds: VideoDataset, order: Sequence[int], batch_size: int,
                 bucket_sizes: Sequence[int]) -> list[tuple[int, list[int]]]:
    """JAX's ``_make_batches``: the videos of ``order`` grouped by bucket, the
    buckets in order of first appearance, each cut into batches of at most
    ``batch_size``. Returns [(bucket, video indices)]."""
    by_bucket: dict[int, list[int]] = {}
    for i in order:
        by_bucket.setdefault(bucket_length(int(ds.lengths[i]), bucket_sizes), []).append(i)
    return [(b, vids[k:k + batch_size]) for b, vids in by_bucket.items()
            for k in range(0, len(vids), batch_size)]


def collate(ds: VideoDataset, bucket: int, vids: Sequence[int]):
    """(feats [B, T, D], labels [B, T], ant [B, T, P], mask [B, T]) as numpy:
    one video at its true length, several right-padded to ``bucket`` as
    JAX's ``_collate``."""
    if len(vids) == 1:
        f, l, a = ds.video_arrays(vids[0])
        return f[None], l[None], a[None], np.ones((1, len(l)), bool)
    parts = []
    for i in vids:
        f, l, a = ds.video_arrays(i)
        f, m = pad_video(f, bucket)
        parts.append((f, pad_video(l, bucket)[0], pad_video(a, bucket)[0], m))
    return tuple(np.stack(p) for p in zip(*parts))


def epoch_metrics(ds: VideoDataset, preds: list, num_phases: int, horizon: float,
                  ant_preds: list) -> dict:
    """The reference's metric set over a split's per-video predictions."""
    triad = MAETriad(horizon=horizon)
    per_video_acc, all_l = [], []
    for i, (pred, ant) in enumerate(zip(preds, ant_preds)):
        _, l, a = ds.video_arrays(i)
        triad.update(ant, a)
        per_video_acc.append(frame_accuracy(l, pred))
        all_l.append(l)
    flat_p, flat_l = np.concatenate(preds), np.concatenate(all_l)
    return {
        "acc_frame": frame_accuracy(flat_l, flat_p),
        "acc_video": float(np.mean(per_video_acc)),
        **triad.result(),
        **{k: v for k, v in precision_recall_jaccard(flat_l, flat_p, num_phases).items()
           if np.isscalar(v)},
    }


class TemporalTrainer:
    """Trains ``model`` ([B, T, f_dim] -> [S, B, T, out], with a ``masks``
    argument for dropout) in place, on the device its parameters lie on."""

    def __init__(self, model, cfg: TrainConfig, num_phases: int = 7):
        self.model = model
        self.cfg = cfg
        self.num_phases = num_phases
        self.device = next(model.parameters()).device
        self.class_weights = torch.tensor(cfg.class_weights, dtype=torch.float32,
                                          device=self.device)
        o = cfg.optim
        self.plateau = PlateauController(mode=o.plateau_mode, factor=o.plateau_factor,
                                         patience=o.plateau_patience, min_lr=o.plateau_min_lr)

    def init(self) -> torch.optim.Optimizer:
        """The optimizer over the model's parameters (AdamW, clip 1.0 by
        default: ``OptimConfig``)."""
        return build_optimizer(self.cfg.optim, self.model.parameters())

    def train_step(self, opt, feats, labels, ant, mask, masks: DropoutMasks):
        """One optimizer step on a batch of tensors on the device. Returns
        (loss, clc, ant, correct) as 0-d tensors."""
        self.model.train()
        out = self.model(feats, masks=masks)
        total, clc, antl = temporal_stage_loss(out, labels, ant, self.class_weights, mask,
                                               self.num_phases)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        with torch.no_grad():
            preds = out[-1][..., :self.num_phases].argmax(-1)
            correct = ((preds == labels) & mask).sum()
        return total.detach(), clc.detach(), antl.detach(), correct

    def train_epoch(self, opt, ds: VideoDataset, seed: int, epoch: int, batch_size: int = 1,
                    shuffle: bool = False) -> dict:
        """One pass over ``ds`` in JAX's batch order (shuffled first by
        ``host_rng(seed, epoch)`` if asked); the summed losses, the frame
        accuracy and the seconds, under JAX's keys."""
        order = list(range(ds.num_videos))
        if shuffle:
            rnglib.host_rng(seed, epoch).shuffle(order)
        total = clc_sum = ant_sum = 0.0
        correct = 0
        t0 = time.time()
        dev = lambda a: torch.tensor(a, device=self.device)
        for bi, (bucket, vids) in enumerate(make_batches(ds, order, batch_size,
                                                         self.cfg.bucket_sizes)):
            feats, labels, ant, mask = map(dev, collate(ds, bucket, vids))
            loss, clc, antl, corr = self.train_step(
                opt, feats, labels.long(), ant, mask,
                dropout_masks(seed, epoch, bi, self.device))
            total += float(loss)
            clc_sum += float(clc)
            ant_sum += float(antl)
            correct += int(corr)
        return {
            "train_loss": total,
            "train_loss_phase": clc_sum,
            "train_loss_ant": ant_sum,
            "train_acc": correct / int(ds.lengths.sum()),
            "train_time_s": time.time() - t0,
        }

    @torch.no_grad()
    def evaluate(self, ds: VideoDataset, horizon: float | None = None):
        """Final-stage predictions per video (eval mode, true length) and the
        reference's metric set: (metrics, per-video phase predictions)."""
        self.model.eval()
        horizon = horizon if horizon is not None else self.cfg.horizon
        preds, ants = [], []
        for i in range(ds.num_videos):
            f, _, _ = ds.video_arrays(i)
            out = self.model(torch.tensor(f, device=self.device)[None])[-1, 0].cpu().numpy()
            preds.append(np.argmax(out[:, :self.num_phases], axis=-1))
            ants.append(out[:, self.num_phases:])
        return epoch_metrics(ds, preds, self.num_phases, horizon, ants), preds

    def plateau_step(self, opt, metric: float) -> float:
        """ReduceLROnPlateau on ``metric``: the lr after this epoch, set in
        the optimizer."""
        lr = get_lr(opt)
        new_lr = self.plateau.step(metric, lr)
        if new_lr != lr:
            set_lr(opt, new_lr)
        return new_lr
