"""Supervised 4-head losses and accuracy (JAX counterpart: ``train/losses.py``):
focal loss (gamma 2, softmax clamped to [1e-7, 1 - 1e-7]) or cross-entropy
with label smoothing 0.1 and optional class weights, summed over heads."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..config.schema import LossBalanceScheme


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Mean over the batch of sum_c -(1 - p_c)^gamma * y_c * log(p_c)."""
    y = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    p = torch.softmax(logits, dim=-1).clamp(1e-7, 1.0 - 1e-7)
    loss = -y * torch.log(p) * (1.0 - p) ** gamma
    return loss.sum(dim=-1).mean()


def smoothed_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.1,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight, label_smoothing) semantics: weighted
    mean over the batch with weights class_weights[label]."""
    n = logits.shape[-1]
    y = F.one_hot(labels.long(), n).to(logits.dtype)
    y = y * (1.0 - label_smoothing) + label_smoothing / n
    per_example = -(y * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    if class_weights is not None:
        w = class_weights[labels.long()]
        return (per_example * w).sum() / torch.clamp(w.sum(), min=1e-9)
    return per_example.mean()


def multi_head_loss(
    logits: Mapping[str, torch.Tensor],
    labels: Mapping[str, torch.Tensor],
    scheme: LossBalanceScheme = LossBalanceScheme.focal,
    class_weights: Mapping[str, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the per-head losses."""
    per_head = {}
    for key, lg in logits.items():
        if scheme == LossBalanceScheme.focal:
            per_head[key] = focal_loss(lg, labels[key])
        else:
            w = class_weights.get(key) if class_weights else None
            per_head[key] = smoothed_cross_entropy(lg, labels[key], 0.1, w)
    return sum(per_head.values()), per_head


def multi_head_accuracy(
    logits: Mapping[str, torch.Tensor], labels: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Per-head mean accuracy."""
    return {
        key: (lg.argmax(dim=-1) == labels[key].long()).float().mean()
        for key, lg in logits.items()
    }
