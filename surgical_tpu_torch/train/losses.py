"""Loss functions with the reference's semantics.

Port of ``surgical_tpu/train/losses.py`` (``weighted_cross_entropy``,
``smooth_l1``, ``temporal_stage_loss``, ``refiner_loss``, ``backbone_loss``).
``weighted_cross_entropy`` is torch.nn.CrossEntropyLoss: the mean divides by
the SUM OF THE WEIGHTS of the target classes. ``smooth_l1`` is
torch.nn.SmoothL1Loss with beta 1.0. Both take an optional validity mask.
The backbone stage uses sum reduction for both (train_evp.py:390-391).
"""

from __future__ import annotations

import torch


def weighted_cross_entropy(logits, labels, class_weights=None, mask=None,
                           reduction: str = "mean"):
    """logits [..., C], integer labels [...], mask bool [...] (True = valid).
    The mean divides by sum(w[y_i]) over the valid i."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = class_weights[labels.long()] if class_weights is not None else torch.ones_like(nll)
    if mask is not None:
        w = w * mask.to(w.dtype)
    total = (w * nll).sum()
    if reduction == "sum":
        return total
    return total / torch.clamp(w.sum(), min=1e-12)


def smooth_l1(pred, target, beta: float = 1.0, mask=None, reduction: str = "mean"):
    """torch.nn.SmoothL1Loss semantics; mask [...] over pred's leading axes."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if mask is not None:
        m = mask[..., None].expand(loss.shape).to(loss.dtype)
        loss = loss * m
        denom = torch.clamp(m.sum(), min=1e-12)
    else:
        denom = loss.numel()
    total = loss.sum()
    if reduction == "sum":
        return total
    return total / denom


def temporal_stage_loss(stage_outputs, labels_phase, labels_ant, class_weights, mask=None,
                        num_phases: int = 7):
    """Joint phase + anticipation loss over every temporal stage
    (tecno.py:236-254): stage_outputs [S, B, T, 2 * num_phases], labels_phase
    [B, T] int, labels_ant [B, T, num_phases], mask [B, T] bool. Returns
    (total, clc, ant), each averaged over the stages."""
    stages = stage_outputs.shape[0]
    clc = ant = stage_outputs.new_zeros(())
    for i in range(stages):
        out = stage_outputs[i]
        clc = clc + weighted_cross_entropy(out[..., :num_phases], labels_phase, class_weights,
                                           mask)
        ant = ant + smooth_l1(out[..., num_phases:], labels_ant, mask=mask)
    clc, ant = clc / stages, ant / stages
    return clc + ant, clc, ant


def refiner_loss(outputs, labels_phase, labels_ant, class_weights, mask=None,
                 num_phases: int = 7, ce_scale: float = 0.5):
    """Refinement-transformer loss ``0.5 * weighted CE + SmoothL1``
    (tecno_trans.py:281-288); outputs [T, 2 * num_phases] or [B, T, ...].
    Returns (total, clc, ant)."""
    clc = weighted_cross_entropy(outputs[..., :num_phases], labels_phase, class_weights, mask)
    ant = smooth_l1(outputs[..., num_phases:], labels_ant, mask=mask)
    return ce_scale * clc + ant, clc, ant


def backbone_loss(logits, ant_pred, labels_phase, labels_ant):
    """Backbone training loss: sum-reduction CE + sum-reduction SmoothL1
    (train_evp.py:390-391,509). Returns (total, ce, reg)."""
    ce = weighted_cross_entropy(logits, labels_phase, reduction="sum")
    reg = smooth_l1(ant_pred, labels_ant, reduction="sum")
    return ce + reg, ce, reg
