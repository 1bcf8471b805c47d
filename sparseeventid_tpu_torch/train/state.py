"""Training state: the model (parameters and running statistics live in
it), its optimizer and schedule, and the step counter (JAX counterpart:
``train/state.py``, where the same four are leaves of one pytree)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0  # train steps taken (micro-steps under accumulation)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
