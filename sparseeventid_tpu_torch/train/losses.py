"""Losses and accuracy (JAX counterpart: ``train/losses.py``): for the
supervised heads focal loss (gamma 2, softmax clamped to [1e-7, 1 - 1e-7])
or cross-entropy with label smoothing 0.1 and optional class weights,
summed over heads; for SimCLR the NT-Xent loss, over the batches of every
rank under data parallelism, and its top-k retrieval accuracy."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from ..config.schema import LossBalanceScheme
from ..parallel import mesh


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


def _view_similarity(z1: torch.Tensor, z2: torch.Tensor, temperature: float):
    """-> (sim [2N, 2N] over both views, self-pairs at -1e9, and the index
    of each row's positive, i +- N).  The normalisation is smooth,
    z * rsqrt(sum z^2 + 1e-12), so an empty view's gradient stays finite."""
    n = z1.shape[0]
    z = torch.cat([z1, z2], dim=0)
    z = z * torch.rsqrt((z * z).sum(dim=-1, keepdim=True) + 1e-12)
    sim = z @ z.T / temperature
    eye = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, -1e9)
    idx = torch.arange(n, device=z.device)
    return sim, torch.cat([idx + n, idx])


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor,
                 temperature: float = 0.1, sync: bool = False) -> torch.Tensor:
    """SimCLR NT-Xent: z1, z2 [N, D] the two views' projections; each of
    the 2N rows competes its positive against the 2N - 2 negatives.

    With ``sync`` (JAX's ``axis_name``) z1 and z2 are first gathered from
    every rank in rank order (``mesh.all_gather_rows``), so every rank
    computes the loss of the global batch; the gather's backward hands each
    rank the gradient of its own rows summed over the ranks' losses, which
    the gradient mean then brings to the global loss's gradient."""
    if sync:
        z1, z2 = mesh.all_gather_rows(z1), mesh.all_gather_rows(z2)
    sim, pos = _view_similarity(z1, z2, temperature)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp.gather(1, pos[:, None])[:, 0].mean()


def nt_xent_top_k_accuracy(z1: torch.Tensor, z2: torch.Tensor,
                           temperature: float = 0.1, k: int = 1
                           ) -> torch.Tensor:
    """The share of rows whose positive is among their k most similar
    (k at most 2N - 1, for tiny batches)."""
    sim, pos = _view_similarity(z1, z2, temperature)
    k = min(k, 2 * z1.shape[0] - 1)
    top = sim.topk(k, dim=-1).indices
    return (top == pos[:, None]).any(dim=-1).float().mean()
