"""Optimizer construction and plateau LR control.

Port of ``surgical_tpu/train/optim.py``. ``build_optimizer`` returns a
``torch.optim`` optimizer over the parameters it is given, with the update
rules of the optax chain the JAX package builds:

- ``sgd``: optax's momentum trace (t = g + 0.9 t; p -= lr t), which is
  ``torch.optim.SGD(momentum=0.9)`` with dampening 0;
- ``adam`` / ``adamw``: the betas and eps of ``OptimConfig``; adamw's weight
  decay decoupled (p -= lr wd p), as ``optax.adamw`` and ``torch.optim.AdamW``;
- an optional global-norm clip ahead of the update (``optax.clip_by_global_norm``:
  g * max_norm / ||g|| when ||g|| >= max_norm), run by a step pre-hook so
  that ``optimizer.step()`` clips first.

The learning rate lives in the parameter groups (``get_lr`` / ``set_lr``),
where the plateau controller changes it between epochs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from surgical_tpu_torch.core.config import OptimConfig


def _clip_by_global_norm(params, max_norm: float) -> None:
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def build_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    params = [p for p in params if p.requires_grad]
    if cfg.name == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps,
                                weight_decay=cfg.weight_decay)
    elif cfg.name == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=cfg.eps)
    elif cfg.name == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {cfg.name}")
    if cfg.grad_clip_norm is not None:
        max_norm = float(cfg.grad_clip_norm)
        opt.register_step_pre_hook(lambda o, args, kwargs: _clip_by_global_norm(
            [p for g in o.param_groups for p in g["params"]], max_norm))
    return opt


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for g in opt.param_groups:
        g["lr"] = lr


@dataclass
class PlateauController:
    """Host-side ReduceLROnPlateau (torch semantics, tecno.py:171-177)."""

    mode: str = "max"
    factor: float = 0.5
    patience: int = 3
    min_lr: float = 1e-6
    best: float | None = None
    bad_epochs: int = 0

    def step(self, metric: float, lr: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr
