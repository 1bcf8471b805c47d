"""Masked batch normalization over active voxels only (scn.BatchNormalization
semantics: statistics over the live rows of the whole minibatch)."""

from __future__ import annotations

from typing import Tuple

import torch


def masked_batch_stats(
    feats: torch.Tensor,  # [B, N, C]
    mask: torch.Tensor,  # bool[B, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel over the active rows of the whole batch."""
    m = mask[..., None].float()
    f = feats.float()
    count = torch.clamp(m.sum(), min=1.0)
    mean = (f * m).sum(dim=(0, 1)) / count
    var = torch.clamp((f * f * m).sum(dim=(0, 1)) / count - mean * mean, min=0.0)
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
