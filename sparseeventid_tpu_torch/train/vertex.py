"""YOLO-style vertex finding (JAX counterpart: ``train/vertex.py``):
single-anchor 3D vertex regression on the encoder's coarse grid plus an
event class.

The anchor cell that holds the true vertex has objectness 1 and a target
offset in [0, 1) within the cell.  The loss is a focal-weighted BCE on
objectness over the grid, an MSE on the sigmoid offsets at the true cell
(times 5) and a cross-entropy on the event class.  The metrics are the
fractions of events whose predicted vertex lies within 5, 10 and 20 cm
(dune3d: 0.4 cm voxels).

The head is dense: the encoder's output through ``to_dense`` (channels
last, [B, X, Y, Z, C]), a 3x3x3 conv (padding 1, flax's ``SAME``), leaky
ReLU 0.01, a 1x1x1 conv to (logit, dx, dy, dz) and, from the mean of the
hidden map, the event logits.  It computes in float32 whatever the
encoder's feature type, as flax's ``nn.Conv`` / ``nn.Dense`` with float32
parameters do.  The dense convs are ``torch.nn.functional.conv3d``: the
JAX package computes them in XLA, outside any Pallas kernel.

Under data parallelism the train and eval steps' metrics are the mean
across ranks, ``overflow/dropped`` the sum (``mesh.reduce_metrics``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config.schema import ConvRepresentation
from ..models.encoder import Encoder
from ..ops import SparseTensor, to_dense
from ..ops.window.query import WindowTuning
from ..parallel import mesh
from .state import TrainState

CM_PER_VOXEL = 0.4  # dune3d meta


class VertexHead(nn.Module):
    """dense [B, X, Y, Z, C] -> (anchor map [B, X, Y, Z, 4], event logits)."""

    def __init__(self, c_in: int, n_event_classes: int = 3, hidden: int = 64):
        super().__init__()
        self.conv1 = nn.Conv3d(c_in, hidden, 3, padding=1)
        self.anchor_out = nn.Conv3d(hidden, 4, 1)
        self.event_out = nn.Linear(hidden, n_event_classes)

    def forward(self, dense: torch.Tensor):
        x = dense.float().permute(0, 4, 1, 2, 3)  # channels first for conv3d
        h = self.conv1(x)
        # flax's leaky_relu, where(h >= 0, h, 0.01 h): slope 1 at 0, where
        # every empty cell sits while the bias is 0 (F.leaky_relu: 0.01)
        h = torch.where(h >= 0, h, 0.01 * h)
        anchor = self.anchor_out(h).permute(0, 2, 3, 4, 1)
        event_logits = self.event_out(h.mean(dim=(2, 3, 4)))
        return anchor, event_logits


class VertexModel(nn.Module):
    """forward(st, plans=None) -> (anchor map, event logits, dropped)."""

    def __init__(
        self,
        encoder_cfg: ConvRepresentation,
        dimension: int = 3,
        capacities: Tuple[int, ...] = (),
        n_event_classes: int = 3,
        backend: str = "xla",
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.encoder = Encoder(encoder_cfg, dimension, capacities,
                               backend=backend, tuning=tuning, sync_bn=sync_bn,
                               remat=remat)
        self.head = VertexHead(encoder_cfg.n_output_filters, n_event_classes)

    def forward(self, st: SparseTensor, plans=None):
        encoded, dropped = self.encoder(st, plans)
        anchor, event_logits = self.head(to_dense(encoded))
        return anchor, event_logits, dropped


def _cell_scale(anchor_grid, full_grid, device) -> torch.Tensor:
    return torch.tensor([f / a for f, a in zip(full_grid, anchor_grid)],
                        dtype=torch.float32, device=device)


def build_vertex_labels(vertex: torch.Tensor, anchor_grid: Tuple[int, ...],
                        full_grid: Tuple[int, ...]):
    """vertex [B, 3] in voxels of the full grid -> (objectness [B, X, Y, Z],
    offset in the cell [B, 3], cell [B, 3])."""
    cell_f = vertex / _cell_scale(anchor_grid, full_grid, vertex.device)
    top = torch.tensor(anchor_grid, dtype=torch.int32, device=vertex.device) - 1
    cell = torch.minimum(torch.maximum(cell_f.to(torch.int32),
                                       torch.zeros_like(top)), top)
    offset = cell_f - cell
    b = vertex.shape[0]
    obj = torch.zeros((b, *anchor_grid), dtype=torch.float32,
                      device=vertex.device)
    rows = torch.arange(b, device=vertex.device)
    obj[rows, cell[:, 0].long(), cell[:, 1].long(), cell[:, 2].long()] = 1.0
    return obj, offset, cell


def _at_cell(anchor: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(anchor.shape[0], device=anchor.device)
    c = cell.long()
    return anchor[rows, c[:, 0], c[:, 1], c[:, 2]]


def vertex_loss(anchor: torch.Tensor, event_logits: torch.Tensor,
                obj_target: torch.Tensor, offset_target: torch.Tensor,
                cell: torch.Tensor, event_label: torch.Tensor,
                lambda_obj: float = 1.0, lambda_off: float = 5.0,
                lambda_evt: float = 1.0):
    """-> (total, {loss/objectness, loss/offset, loss/event})."""
    p = torch.sigmoid(anchor[..., 0])
    bce = -(obj_target * torch.log(p.clamp(1e-7, 1.0))
            + (1 - obj_target) * torch.log((1 - p).clamp(1e-7, 1.0)))
    focal = torch.where(obj_target > 0, (1 - p) ** 2 * 100.0, p**2)
    obj_loss = (focal * bce).mean(dim=(1, 2, 3)).mean()
    pred_off = torch.sigmoid(_at_cell(anchor, cell)[:, 1:])
    off_loss = ((pred_off - offset_target) ** 2).sum(dim=-1).mean()
    logp = torch.log_softmax(event_logits, dim=-1)
    evt_loss = -logp.gather(1, event_label.long()[:, None]).mean()
    total = lambda_obj * obj_loss + lambda_off * off_loss + lambda_evt * evt_loss
    return total, {"loss/objectness": obj_loss, "loss/offset": off_loss,
                   "loss/event": evt_loss}


def predict_vertex(anchor: torch.Tensor, anchor_grid: Tuple[int, ...],
                   full_grid: Tuple[int, ...]) -> torch.Tensor:
    """The most likely anchor cell plus its predicted offset -> vertex
    [B, 3] in voxels of the full grid."""
    b = anchor.shape[0]
    idx = anchor[..., 0].reshape(b, -1).argmax(dim=-1)
    cx = idx // (anchor_grid[1] * anchor_grid[2])
    cy = (idx // anchor_grid[2]) % anchor_grid[1]
    cz = idx % anchor_grid[2]
    cell = torch.stack([cx, cy, cz], dim=-1)
    off = torch.sigmoid(_at_cell(anchor, cell)[:, 1:])
    return (cell.float() + off) * _cell_scale(anchor_grid, full_grid,
                                              anchor.device)


def vertex_resolution_metrics(pred: torch.Tensor, true: torch.Tensor,
                              cm_per_voxel: float = CM_PER_VOXEL
                              ) -> Dict[str, torch.Tensor]:
    """Mean distance and the fractions within 5, 10 and 20 cm."""
    dist = torch.linalg.vector_norm(pred - true, dim=-1) * cm_per_voxel
    return {
        "vertex/mean_dist_cm": dist.mean(),
        "vertex/frac_5cm": (dist < 5.0).float().mean(),
        "vertex/frac_10cm": (dist < 10.0).float().mean(),
        "vertex/frac_20cm": (dist < 20.0).float().mean(),
    }


def _plans(plans_builder, st, host_plans):
    if plans_builder is None or host_plans is None:
        return None
    return plans_builder(st, host_plans)


def vertex_metrics(anchor, event_logits, dropped, vertex, event_label,
                   anchor_grid, full_grid):
    """-> (loss, metrics): the loss, its parts, the resolution metrics and
    the dropped count."""
    obj_t, off_t, cell = build_vertex_labels(vertex, anchor_grid, full_grid)
    loss, parts = vertex_loss(anchor, event_logits, obj_t, off_t, cell,
                              event_label)
    metrics = {"loss/loss": loss, **parts, "overflow/dropped": dropped}
    with torch.no_grad():
        pred = predict_vertex(anchor.detach(), anchor_grid, full_grid)
        metrics.update(vertex_resolution_metrics(pred, vertex))
    return loss, metrics


def make_vertex_train_step(state: TrainState, anchor_grid, full_grid,
                           lr_schedule=None, gradient_accumulation: int = 1,
                           plans_builder=None):
    """Returns step(st, vertex, event_label, host_plans=None,
    generator=None) -> metrics, which advances ``state`` by one step (the
    generator is unused: the model has no dropout)."""
    model = state.model
    every = max(int(gradient_accumulation), 1)

    def step(st, vertex, event_label, host_plans=None, generator=None):
        model.train()
        anchor, event_logits, dropped = model(
            st, _plans(plans_builder, st, host_plans))
        loss, metrics = vertex_metrics(anchor, event_logits, dropped, vertex,
                                       event_label, anchor_grid, full_grid)
        loss.backward()
        metrics = mesh.reduce_metrics({k: v.detach() for k, v in metrics.items()})
        if lr_schedule is not None:
            metrics["opt/lr"] = lr_schedule(state.step)
        state.apply_gradients(every)
        return metrics

    return step


def make_vertex_eval_step(model: VertexModel, anchor_grid, full_grid,
                          plans_builder=None):
    """Returns step(st, vertex, event_label, host_plans=None) -> metrics."""

    @torch.no_grad()
    def step(st, vertex, event_label, host_plans=None):
        model.eval()
        anchor, event_logits, dropped = model(
            st, _plans(plans_builder, st, host_plans))
        return mesh.reduce_metrics(vertex_metrics(
            anchor, event_logits, dropped, vertex, event_label, anchor_grid,
            full_grid)[1])

    return step


def make_vertex_predict_step(model: VertexModel, anchor_grid, full_grid,
                             plans_builder=None):
    """Returns step(st, vertex, event_label, host_plans=None) -> the
    per-event outputs inference saves: label, vertex_true, anchor (the
    objectness map), vertex (predicted) and pred_label."""

    @torch.no_grad()
    def step(st, vertex, event_label, host_plans=None):
        model.eval()
        anchor, event_logits, _ = model(st, _plans(plans_builder, st,
                                                   host_plans))
        return {
            "label": event_label,
            "vertex_true": vertex,
            "anchor": torch.sigmoid(anchor[..., 0]),
            "vertex": predict_vertex(anchor, anchor_grid, full_grid),
            "pred_label": event_logits.argmax(dim=-1),
        }

    return step
