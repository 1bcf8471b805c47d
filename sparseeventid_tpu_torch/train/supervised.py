"""Supervised 4-head event ID, forward only (JAX counterpart:
``train/supervised.py`` ``make_eval_step`` / ``make_predict_step``).

The steps take the model, which holds its parameters, and run it in eval
mode without autograd.  The train step is the next slice of the port."""

from __future__ import annotations

from typing import Dict

import torch

from ..config.schema import LossBalanceScheme
from ..ops import SparseTensor
from .losses import multi_head_accuracy, multi_head_loss


def eval_metrics(logits, labels, dropped, scheme, class_weights=None
                 ) -> Dict[str, torch.Tensor]:
    """Loss, per-head accuracy and the dropped count of one forward."""
    loss, _ = multi_head_loss(logits, labels, scheme, class_weights)
    metrics = {"loss/loss": loss, "overflow/dropped": dropped}
    metrics.update(
        {f"acc/{k}": v for k, v in multi_head_accuracy(logits, labels).items()}
    )
    return metrics


def make_eval_step(model, scheme: LossBalanceScheme, class_weights=None):
    """Returns step(st, labels) -> metrics (device tensors)."""

    @torch.no_grad()
    def step(st: SparseTensor, labels) -> Dict[str, torch.Tensor]:
        model.eval()
        logits, dropped = model(st)
        return eval_metrics(logits, labels, dropped, scheme, class_weights)

    return step


def make_predict_step(model):
    """Returns step(st) -> softmax per head."""

    @torch.no_grad()
    def step(st: SparseTensor) -> Dict[str, torch.Tensor]:
        model.eval()
        logits, _ = model(st)
        return {k: torch.softmax(v, dim=-1) for k, v in logits.items()}

    return step
