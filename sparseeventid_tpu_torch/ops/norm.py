"""Masked normalizations over active voxels only: batch norm
(scn.BatchNormalization semantics: statistics over the live rows of the
whole minibatch, and with sync batch norm over the minibatches of every
rank) and group norm (scn.SparseGroupNorm: statistics per event and group
over its live rows)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import mesh


def masked_batch_stats(
    feats: torch.Tensor,  # [B, N, C]
    mask: torch.Tensor,  # bool[B, N]
    sync: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel over the active rows of the whole batch.

    With ``sync`` (JAX's ``axis_name``) the live count and the two sums are
    packed into one tensor and summed over every rank of the process group
    before the count is clamped and the mean and variance formed: sync
    batch norm.  Per-rank means or variances cannot be averaged instead,
    since sparse events give each rank its own live count.  Without a group
    the result is the unsynced one, bit for bit."""
    m = mask[..., None].float()
    f = feats.float()
    count = m.sum()
    s1 = (f * m).sum(dim=(0, 1))
    s2 = (f * f * m).sum(dim=(0, 1))
    if sync:
        c = s1.shape[0]
        packed = mesh.all_reduce_sum(torch.cat([count.reshape(1), s1, s2]))
        count, s1, s2 = packed[0], packed[1:1 + c], packed[1 + c:]
    count = torch.clamp(count, min=1.0)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    return mean, var


def apply_norm(
    feats: torch.Tensor,
    mask: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    scale: torch.Tensor | None,
    offset: torch.Tensor | None,
    eps: float = 1e-4,
) -> torch.Tensor:
    out = (feats.float() - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale
    if offset is not None:
        out = out + offset
    out = torch.where(mask[..., None], out, 0.0)
    return out.to(feats.dtype)


def masked_group_norm(
    feats: torch.Tensor,  # [B, N, C]
    mask: torch.Tensor,  # bool[B, N]
    num_groups: int,
    scale: torch.Tensor | None,
    offset: torch.Tensor | None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """scn.SparseGroupNorm: per-event, per-group statistics over the live
    rows.  The count is live rows x C/G, clamped to 1, and the variance
    E[x^2] - E[x]^2, clamped to 0.  No collective: an event's statistics
    are its own, on any rank."""
    b, n, c = feats.shape
    g = num_groups
    f = feats.float().reshape(b, n, g, c // g)
    m = mask[:, :, None, None].float()
    count = torch.clamp(m.sum(dim=(1, 3)) * (c // g), min=1.0)  # [B, G]
    mean = (f * m).sum(dim=(1, 3)) / count
    var = torch.clamp((f * f * m).sum(dim=(1, 3)) / count - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    out = (f - mean[:, None, :, None]) * inv[:, None, :, None]
    out = out.reshape(b, n, c)
    if scale is not None:
        out = out * scale
    if offset is not None:
        out = out + offset
    out = torch.where(mask[..., None], out, 0.0)
    return out.to(feats.dtype)
