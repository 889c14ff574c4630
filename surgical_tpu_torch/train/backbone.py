"""Backbone (spatial-stage) training: the train_evp.py / finetune_evp.py
step on the fused training graph.

Port of ``surgical_tpu/train/backbone.py`` for ``use_fused=True``. The
reference recipe (train_evp.py): sum-reduction CE + sum-reduction SmoothL1
(:390-391,509); every parameter frozen except the head, the prompt
generator, the flow encoder and the two cross-attention fusions
(:379-382). Here: bf16 compute, fp32 parameters and optimizer state, the
frozen parameters with ``requires_grad=False`` and outside the optimizer,
the frozen MiT blocks on the fused train kernels in both directions
(``models/mit_train.py``).

The flax training graph (``use_fused=False`` in the JAX package) is not
ported (ROADMAP Queue 1 item 3). Evaluation runs the port's serving graph
(``models/mit_fused.py``), where the JAX trainer runs the flax graph in
eval mode (ROADMAP Queue 3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from surgical_tpu_torch.core import rng as rnglib
from surgical_tpu_torch.core.config import TrainConfig
from surgical_tpu_torch.data.transforms import (AugConfig, eval_preprocess_clip,
                                                train_preprocess_batch)
from surgical_tpu_torch.models.mit_fused import fused_forward
from surgical_tpu_torch.models.mit_train import fused_train_forward, write_bn_stats
from surgical_tpu_torch.train.losses import backbone_loss
from surgical_tpu_torch.train.optim import build_optimizer

# Parameter-name parts that stay trainable (train_evp.py:379-382).
TRAINABLE_KEYS = ("head", "prompt_generator", "flow_encoder", "cross_attn_s3", "cross_attn_s4")

_NOT_PORTED = ("the flax training graph (use_fused=False) is not ported yet "
               "(ROADMAP Queue 1 item 3); use the fused trunk")


def is_trainable(name: str) -> bool:
    """True for a parameter under a trainable top-level module."""
    return any(k in part for part in name.split(".") for k in TRAINABLE_KEYS)


def freeze_trunk(model) -> list:
    """Set ``requires_grad`` from ``TRAINABLE_KEYS``; returns the trainable
    parameters. Fails if a trunk block or norm would train: the fused blocks
    give their weights no gradient, so such a parameter would silently stay
    where it is."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        if p.requires_grad:
            assert not ("block" in name or name.startswith("norm")), (
                f"the fused trunk requires a frozen trunk, but {name} is trainable")
            trainable.append(p)
    return trainable


@dataclass
class EarlyStop:
    """Stop when train loss drops below a target (finetune_evp.py:594-616)."""

    target_train_loss: float = 0.0144
    stopped: bool = False

    def update(self, train_loss: float) -> bool:
        if train_loss < self.target_train_loss:
            self.stopped = True
        return self.stopped


class BackboneTrainer:
    """Epoch-level orchestration of the spatial stage (train_evp.py:300-908,
    finetune_evp.py): wire-format host batches, per-image synchronized
    augmentation on the device, the frozen-trunk train step, mid-epoch
    validation every ``val_every`` steps (train_evp.py:526-564).

    The model (a port ``MiTEVP``) and the optimizer hold the state: a
    checkpoint saves ``model.state_dict()`` (parameters and BatchNorm
    statistics) and ``optimizer.state_dict()``."""

    def __init__(self, model, cfg: TrainConfig, aug_cfg: AugConfig | None = None,
                 val_every: int = 15, use_fused: bool = False,
                 compute_dtype=torch.bfloat16):
        if not use_fused:
            raise NotImplementedError(_NOT_PORTED)
        self.model = model
        self.cfg = cfg
        self.aug_cfg = aug_cfg or AugConfig()
        self.val_every = val_every
        self.dtype = compute_dtype
        self.device = next(model.parameters()).device
        self.optimizer = None
        self.step_ms: list[float] = []

    def init(self) -> torch.optim.Optimizer:
        """Freeze the trunk and build the optimizer over the trainable
        parameters only."""
        self.optimizer = build_optimizer(self.cfg.optim, freeze_trunk(self.model))
        return self.optimizer

    # -- wire format -> device float ----------------------------------------
    def _to_device(self, a):
        return None if a is None else torch.as_tensor(a).to(self.device, non_blocking=True)

    def _dequant(self, img_u8, seg_u8, flow_f16):
        """uint8 / 255 in the compute dtype; the segmap broadcast to 3
        channels; flow cast to the compute dtype."""
        dt = self.dtype
        img = img_u8.to(dt) / 255.0
        seg = (seg_u8.to(dt) / 255.0).expand(img.shape)
        return img, seg, None if flow_f16 is None else flow_f16.to(dt)

    def _generator(self, epoch: int, step: int, purpose: str) -> torch.Generator:
        return rnglib.generator(self.cfg.seed, epoch, step, purpose=purpose, device=self.device)

    # -- steps ----------------------------------------------------------------
    def loss_and_grad(self, img_u8, seg_u8, flow_f16, labels, ant, epoch: int = 0,
                      step: int = 0, aug_params=None, masks=None):
        """Forward and backward on a wire-format batch, leaving the
        gradients in the trainable parameters' ``.grad``; returns ({loss, ce,
        reg, correct} as device tensors, the new BatchNorm statistics).
        ``aug_params`` / ``masks`` replace the draws of (epoch, step)'s
        generators."""
        img, seg, flow = self._dequant(*map(self._to_device, (img_u8, seg_u8, flow_f16)))
        img, seg, flow = train_preprocess_batch(
            img, seg, flow, self._generator(epoch, step, "augment"), self.aug_cfg, aug_params)
        labels, ant = self._to_device(labels).long(), self._to_device(ant).float()
        y, y_ant, stats = fused_train_forward(
            self.model, img, seg, flow, generator=self._generator(epoch, step, "droppath"),
            masks=masks, dtype=self.dtype)
        y = y.float()
        loss, ce, reg = backbone_loss(y, y_ant.float(), labels, ant)
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        correct = (y.argmax(-1) == labels).sum()
        return {"loss": loss.detach(), "ce": ce.detach(), "reg": reg.detach(),
                "correct": correct}, stats

    def train_step(self, img_u8, seg_u8, flow_f16, labels, ant, epoch: int = 0, step: int = 0,
                   aug_params=None, masks=None) -> dict:
        """One optimizer step (``loss_and_grad``, the update, the BatchNorm
        statistics written); returns the step's loss, ce, reg and correct."""
        out, stats = self.loss_and_grad(img_u8, seg_u8, flow_f16, labels, ant, epoch, step,
                                        aug_params, masks)
        self.optimizer.step()
        write_bn_stats(self.model, stats)
        return out

    @torch.no_grad()
    def eval_step(self, img_u8, seg_u8, flow_f16):
        """(phase logits, anticipation) fp32 from the serving graph."""
        img, seg, flow = self._dequant(*map(self._to_device, (img_u8, seg_u8, flow_f16)))
        img, seg, flow = eval_preprocess_clip(img, seg, flow, self.aug_cfg)
        y, y_ant = fused_forward(self.model, img, seg, flow, return_features=False)
        return y.float(), y_ant.float()

    # -- loops ----------------------------------------------------------------
    def train_epoch(self, batches, epoch: int, val_batches=None, logger=None,
                    step_offset: int = 0) -> dict:
        """One pass over ``batches`` of (img_u8, seg_u8, flow_f16, labels,
        ant). ``step_ms`` holds each step's host time, synchronized by the
        read of its loss."""
        total = correct = seen = 0.0
        self.step_ms = []
        t0 = time.perf_counter()
        for bi, (img, seg, flow, labels, ant) in enumerate(batches):
            ts = time.perf_counter()
            out = self.train_step(img, seg, flow, labels, ant, epoch=epoch, step=bi)
            total += float(out["loss"])
            self.step_ms.append((time.perf_counter() - ts) * 1e3)
            correct += int(out["correct"])
            seen += len(labels)
            if val_batches is not None and (bi + 1) % self.val_every == 0:
                vm = self.evaluate(val_batches)
                if logger is not None:
                    logger.log(step_offset + bi, vm, prefix="midval/")
        elapsed = time.perf_counter() - t0
        return {
            "train_loss": total,
            "train_acc": correct / max(seen, 1),
            "train_elapsed_time": elapsed,
            "frames_per_s": seen / max(elapsed, 1e-9),
        }

    def evaluate(self, batches, horizon: float | None = None, num_each=None) -> dict:
        """Frame accuracy, the MAE triad, macro precision/recall/jaccard and,
        given per-video frame counts, mean per-video accuracy
        (train_evp.py:605-907)."""
        from surgical_tpu_torch.eval.metrics import (MAETriad, frame_accuracy,
                                                     precision_recall_jaccard)

        triad = MAETriad(horizon=horizon or self.cfg.horizon)
        preds, labs = [], []
        for img, seg, flow, labels, ant in batches:
            y, y_ant = self.eval_step(img, seg, flow)
            preds.append(y.argmax(-1).cpu().numpy())
            labs.append(np.asarray(labels))
            triad.update(y_ant.cpu().numpy(), np.asarray(ant))
        flat_p = np.concatenate(preds) if preds else np.zeros(0, int)
        flat_l = np.concatenate(labs) if labs else np.zeros(0, int)
        metrics = {"acc": frame_accuracy(flat_l, flat_p), **triad.result()}
        if flat_l.size:
            prj = precision_recall_jaccard(flat_l, flat_p)
            metrics.update({k: v for k, v in prj.items() if np.isscalar(v)})
        if num_each is not None and flat_l.size:
            per_video, off = [], 0
            for n in np.asarray(num_each, dtype=int):
                if off + n > flat_l.size:
                    break
                per_video.append(frame_accuracy(flat_l[off:off + n], flat_p[off:off + n]))
                off += n
            if per_video:
                metrics["acc_video"] = float(np.mean(per_video))
        return metrics
