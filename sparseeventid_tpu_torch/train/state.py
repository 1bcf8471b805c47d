"""Training state: the model (parameters and running statistics live in
it), its optimizer and schedule, and the step counter (JAX counterpart:
``train/state.py``, where the same four are leaves of one pytree)."""

from __future__ import annotations

import dataclasses

import torch

from ..parallel import mesh


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0  # train steps taken (micro-steps under accumulation)

    def apply_gradients(self, every: int = 1) -> None:
        """Count one step whose gradients ``backward`` has added to the
        parameters'; on every ``every``-th, update with their mean over the
        last ``every`` steps and move the schedule on, as
        ``optax.MultiSteps`` does.

        Under data parallelism the gradients are first averaged across
        ranks (JAX ``pmean``), once an optimizer step: with accumulation
        that is the mean over ranks of the summed micro-steps, which equals
        the mean of JAX's per-micro-step ``pmean``."""
        self.step += 1
        if self.step % every:
            return
        mesh.mean_gradients(self.model.parameters())
        if every > 1:
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(every)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
