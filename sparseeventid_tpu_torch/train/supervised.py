"""Supervised 4-head event ID: train, eval and predict steps (JAX
counterpart: ``train/supervised.py``).

The eval and predict steps take the model, which holds its parameters, and
run it in eval mode without autograd.  The train step takes a
``TrainState`` and updates it in place: parameters, running statistics,
optimizer moments, schedule and step counter.

Given a ``plans_builder(st, host_plans) -> EncoderPlans`` (the trainer's
``HostPlanner.plans``), each step takes the batch's host-built plan dict,
on the device, and the encoder builds no plan; without one, or without a
dict, the encoder builds its plans on the device.

Under data parallelism (``parallel/mesh.py``) every step's metrics are the
mean across ranks, ``overflow/dropped`` the sum, as the JAX steps'
``pmean`` / ``psum``."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config.schema import LossBalanceScheme
from ..ops import SparseTensor
from ..parallel import mesh
from ..utils import telemetry
from .losses import multi_head_accuracy, multi_head_loss
from .state import TrainState


def eval_metrics(logits, labels, dropped, scheme, class_weights=None
                 ) -> Dict[str, torch.Tensor]:
    """Loss, per-head accuracy and the dropped count of one forward."""
    loss, _ = multi_head_loss(logits, labels, scheme, class_weights)
    metrics = {"loss/loss": loss, "overflow/dropped": dropped}
    metrics.update(
        {f"acc/{k}": v for k, v in multi_head_accuracy(logits, labels).items()}
    )
    return metrics


def _plans(plans_builder, st, host_plans):
    if plans_builder is None or host_plans is None:
        return None
    with telemetry.span("step.plans"):
        return plans_builder(st, host_plans)


def _evaluate(model, scheme, class_weights, plans_builder, st, labels,
              host_plans):
    """(metrics, logits) of one eval-mode forward."""
    model.eval()
    logits, dropped = model(st, plans=_plans(plans_builder, st, host_plans))
    return mesh.reduce_metrics(
        eval_metrics(logits, labels, dropped, scheme, class_weights)), logits


def make_eval_step(model, scheme: LossBalanceScheme, class_weights=None,
                   plans_builder=None):
    """Returns step(st, labels, host_plans=None) -> metrics (device
    tensors)."""

    @torch.no_grad()
    def step(st: SparseTensor, labels, host_plans=None
             ) -> Dict[str, torch.Tensor]:
        return _evaluate(model, scheme, class_weights, plans_builder, st,
                         labels, host_plans)[0]

    return step


def make_scored_eval_step(model, scheme: LossBalanceScheme, class_weights,
                          plans_builder):
    """Returns step(st, labels, host_plans=None) -> (metrics, softmax per
    head): the eval step's metrics and the predict step's softmax, of one
    forward."""

    @torch.no_grad()
    def step(st: SparseTensor, labels, host_plans=None):
        metrics, logits = _evaluate(model, scheme, class_weights,
                                    plans_builder, st, labels, host_plans)
        return metrics, {k: torch.softmax(v, dim=-1) for k, v in logits.items()}

    return step


def make_predict_step(model, plans_builder=None):
    """Returns step(st, host_plans=None) -> softmax per head."""

    @torch.no_grad()
    def step(st: SparseTensor, host_plans=None) -> Dict[str, torch.Tensor]:
        model.eval()
        logits, _ = model(st, plans=_plans(plans_builder, st, host_plans))
        return {k: torch.softmax(v, dim=-1) for k, v in logits.items()}

    return step


def make_train_step(
    state: TrainState,
    scheme: LossBalanceScheme,
    lr_schedule: Callable[[int], float] | None = None,
    class_weights=None,
    gradient_accumulation: int = 1,
    plans_builder=None,
):
    """Returns step(st, labels, generator=None, host_plans=None) -> metrics
    (device tensors; ``opt/lr`` a float), which advances ``state`` by one
    step.

    With ``gradient_accumulation`` = k the gradients of k consecutive steps
    are averaged and the optimizer moves on every k-th, as
    ``optax.MultiSteps`` does."""
    model = state.model
    k = max(int(gradient_accumulation), 1)

    def step(st: SparseTensor, labels, generator: torch.Generator | None = None,
             host_plans=None) -> Dict[str, torch.Tensor]:
        model.train()
        with telemetry.span("step.forward"):
            logits, dropped = model(st, generator,
                                    _plans(plans_builder, st, host_plans))
        with telemetry.span("step.loss"):
            loss, _ = multi_head_loss(logits, labels, scheme, class_weights)
        with telemetry.span("step.backward"):
            loss.backward()  # adds onto the gradients of earlier micro-steps
        with telemetry.span("step.metrics"), torch.no_grad():
            metrics = {"loss/loss": loss.detach(), "overflow/dropped": dropped}
            acc = multi_head_accuracy(logits, labels)
            metrics.update({f"acc/{name}": v for name, v in acc.items()})
            metrics = mesh.reduce_metrics(metrics)
        if lr_schedule is not None:
            metrics["opt/lr"] = lr_schedule(state.step)
        with telemetry.span("step.optimizer"):
            state.apply_gradients(k)
        return metrics

    return step
