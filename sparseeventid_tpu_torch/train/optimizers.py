"""Optimizer factory (JAX counterpart: ``train/optimizers.py``): Adam with
betas (0.8, 0.9), eps 1e-6, decoupled weight decay, and base lr 1.0 scaled
by the per-step schedule through a ``LambdaLR``.

``torch.optim.AdamW`` under that ``LambdaLR`` is ``optax.adamw`` step for
step: p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p), with lr_t the
schedule at the number of updates made so far.  The scheduler is stepped
after each optimizer step.

A transfer run's frozen encoder (the JAX ``optax.multi_transform`` with
``set_to_zero``) is the caller's: ``trainer.build_training`` passes only the
parameters that need a gradient, so AdamW neither updates nor decays the
encoder's.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from ..config.schema import OptimizerConfig, OptimizerKind


def build_optimizer(
    cfg: OptimizerConfig,
    lr_schedule: Callable[[int], float],
    params: Iterable[torch.nn.Parameter],
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    if cfg.name != OptimizerKind.adam:
        raise NotImplementedError(
            f"optimizer {cfg.name.name} is not ported yet (ROADMAP: the full "
            "trainer); use mode.optimizer.name=adam"
        )
    optimizer = torch.optim.AdamW(
        params, lr=1.0, betas=(0.8, 0.9), eps=1e-6,
        weight_decay=cfg.weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lr_schedule)
    return optimizer, scheduler
