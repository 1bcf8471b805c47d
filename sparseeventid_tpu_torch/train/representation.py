"""SimCLR representation learning (JAX counterpart:
``train/representation.py``): two augmented views through one shared
encoder, a projector, and NT-Xent over the batch, with top-1 / top-5
retrieval of the positive pair as metrics.

The encoder is one module applied to both views, so in training its batch
norms update their running statistics twice a step, view 1 then view 2, as
flax's do.  Each view has its own plans: ``plans_builder(st, host_dict)``
(the trainer's view planner) turns a view's host-built plan dict into the
encoder's plans; without it, or without dicts, the encoder builds them on
the device.

With ``sync`` (JAX's ``axis_name``) the loss is over the projections of
every rank's batch (``losses.nt_xent_loss``).  Top-1 and top-5 are computed
on the rank's own batch and then averaged across ranks, as in JAX; every
metric is reduced across ranks (``mesh.reduce_metrics``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ConvRepresentation
from ..models.encoder import Encoder
from ..models.heads import pool_encoded
from ..ops import SparseTensor
from ..ops.window.query import WindowTuning
from ..parallel import mesh
from ..utils import telemetry
from .losses import nt_xent_loss, nt_xent_top_k_accuracy
from .state import TrainState


class ProjectionHead(nn.Module):
    """SimCLR MLP projector: Linear -> ReLU -> Linear."""

    def __init__(self, c_in: int, hidden: int = 256, out: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(c_in, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class RepresentationModel(nn.Module):
    """forward(view1, view2, plans1=None, plans2=None) -> (z1, z2, dropped),
    ``dropped`` the encoder's count over both views."""

    def __init__(
        self,
        encoder_cfg: ConvRepresentation,
        dimension: int = 3,
        capacities: Tuple[int, ...] = (),
        projection_dim: int = 128,
        backend: str = "xla",
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.encoder = Encoder(encoder_cfg, dimension, capacities,
                               backend=backend, tuning=tuning, sync_bn=sync_bn,
                               remat=remat)
        self.projector = ProjectionHead(encoder_cfg.n_output_filters,
                                        out=projection_dim)

    def forward(self, view1: SparseTensor, view2: SparseTensor, plans1=None,
                plans2=None):
        e1, d1 = self.encoder(view1, plans1)
        z1 = self.projector(pool_encoded(e1))
        e2, d2 = self.encoder(view2, plans2)
        z2 = self.projector(pool_encoded(e2))
        return z1, z2, d1 + d2


def _view_plans(plans_builder, v1, v2, host):
    if plans_builder is None or host is None:
        return None, None
    with telemetry.span("step.plans"):
        return plans_builder(v1, host[0]), plans_builder(v2, host[1])


def simclr_metrics(loss, z1, z2, dropped, temperature: float = 0.1
                   ) -> Dict[str, torch.Tensor]:
    """The loss, top-1 and top-5 retrieval and the dropped count, reduced
    across ranks."""
    return mesh.reduce_metrics({
        "loss/loss": loss,
        "acc/top1": nt_xent_top_k_accuracy(z1, z2, temperature, 1),
        "acc/top5": nt_xent_top_k_accuracy(z1, z2, temperature, 5),
        "overflow/dropped": dropped,
    })


def make_simclr_train_step(state: TrainState, lr_schedule=None,
                           temperature: float = 0.1,
                           gradient_accumulation: int = 1,
                           plans_builder=None, sync: bool = False):
    """Returns step(v1, v2, host_plans=None, generator=None) -> metrics,
    which advances ``state`` by one step (``host_plans`` a pair of plan
    dicts on the device, one a view; the generator is unused: the model
    has no dropout)."""
    model = state.model
    k = max(int(gradient_accumulation), 1)

    def step(v1: SparseTensor, v2: SparseTensor, host_plans=None,
             generator: torch.Generator | None = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        with telemetry.span("step.forward"):
            z1, z2, dropped = model(v1, v2, *_view_plans(
                plans_builder, v1, v2, host_plans))
        with telemetry.span("step.loss"):
            loss = nt_xent_loss(z1, z2, temperature, sync)
        with telemetry.span("step.backward"):
            loss.backward()
        with telemetry.span("step.metrics"), torch.no_grad():
            metrics = simclr_metrics(loss.detach(), z1, z2, dropped,
                                     temperature)
        if lr_schedule is not None:
            metrics["opt/lr"] = lr_schedule(state.step)
        with telemetry.span("step.optimizer"):
            state.apply_gradients(k)
        return metrics

    return step


def make_simclr_eval_step(model: RepresentationModel, temperature: float = 0.1,
                          plans_builder=None, sync: bool = False):
    """Returns step(v1, v2, host_plans=None) -> metrics."""

    @torch.no_grad()
    def step(v1: SparseTensor, v2: SparseTensor, host_plans=None
             ) -> Dict[str, torch.Tensor]:
        model.eval()
        z1, z2, dropped = model(v1, v2, *_view_plans(plans_builder, v1, v2,
                                                     host_plans))
        return simclr_metrics(nt_xent_loss(z1, z2, temperature, sync), z1,
                              z2, dropped, temperature)

    return step
