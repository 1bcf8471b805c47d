"""Host-side format transforms: larcv padded batches -> model inputs."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import SparseTensor, build_sparse_tensor


def larcv_batch_to_sparse_3d(
    image: np.ndarray,
    image_size: Tuple[int, ...],
    capacity: int | None = None,
    device: torch.device | str = "cpu",
) -> SparseTensor:
    """[B, MaxVoxels, D+1] padded with -999 -> SparseTensor on ``device``
    (built there: the sort runs on the card for a CUDA device)."""
    coords = image[..., :-1]
    vals = image[..., -1:]
    valid = np.all(coords != -999.0, axis=-1) & (vals[..., 0] != -999.0)
    coords_i = np.where(valid[..., None], coords, -1).astype(np.int32)
    feats = np.where(valid[..., None], vals, 0).astype(np.float32)
    return build_sparse_tensor(
        torch.from_numpy(coords_i).to(device),
        torch.from_numpy(feats).to(device),
        tuple(image_size),
        capacity=capacity,
    )
