"""Global pooling over a sparse tensor.

Dense AvgPool over the full final grid divides by the grid volume (inactive
voxels are zeros), so the sparse equivalent is a masked sum over live rows
divided by prod(grid_shape)."""

from __future__ import annotations

import numpy as np
import torch

from .sparse_tensor import SparseTensor


def global_avg_pool(st: SparseTensor) -> torch.Tensor:
    """[B, C] masked sum over live rows divided by the grid volume (dense
    AvgPool over the full grid)."""
    m = st.row_mask()[..., None].to(st.feats.dtype)
    return (st.feats * m).sum(dim=1) / float(np.prod(st.grid_shape))


def global_max_pool(st: SparseTensor) -> torch.Tensor:
    """[B, C] max over the live rows; an event with none gives 0."""
    f = torch.where(st.row_mask()[..., None], st.feats, float("-inf"))
    out = f.amax(dim=1)
    return torch.where(torch.isfinite(out), out, 0)
