"""Host-side format transforms: larcv padded batches -> model inputs (a
SparseTensor on the device, or numpy dense grids and point clouds)."""

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


def larcv_batch_to_sparse_2d(
    image: np.ndarray,
    image_size: Tuple[int, ...],
    capacity: int | None = None,
    device: torch.device | str = "cpu",
) -> SparseTensor:
    """[B, planes, MaxVoxels, 3] of (x, y, value), padded with -999 -> the
    plane-axis 3D SparseTensor on ``device``: the plane index is coordinate
    0 on the (planes, H, W) grid, the SECOND stored coordinate (y) is axis 1
    and the FIRST (x) is axis 2.  Pixels outside the grid are dropped."""
    b, planes, n, _ = image.shape
    xy = image[..., :2]
    vals = image[..., 2:3]
    valid = np.all(xy != -999.0, axis=-1) & (vals[..., 0] != -999.0)
    plane_idx = np.broadcast_to(
        np.arange(planes, dtype=np.int32)[None, :, None], (b, planes, n)
    )
    yx = xy[..., ::-1]
    coords3 = np.concatenate(
        [plane_idx[..., None], yx.astype(np.int32)], axis=-1
    )
    h, w = int(image_size[1]), int(image_size[2])
    valid = valid & (
        (yx[..., 0] >= 0) & (yx[..., 0] < h)
        & (yx[..., 1] >= 0) & (yx[..., 1] < w)
    )
    coords3 = np.where(valid[..., None], coords3, -1).reshape(b, planes * n, 3)
    feats = np.where(valid[..., None], vals, 0).astype(np.float32)
    feats = feats.reshape(b, planes * n, 1)
    return build_sparse_tensor(
        torch.from_numpy(np.ascontiguousarray(coords3)).to(device),
        torch.from_numpy(feats).to(device),
        tuple(image_size),
        capacity=capacity,
    )


def _only_3d_images(image: np.ndarray, what: str) -> None:
    if image.ndim != 3:
        raise ValueError(
            f"{what} takes [B, MaxVoxels, D+1] images; got shape "
            f"{image.shape} (2D multiplane images [B, planes, N, 3] are not "
            "converted, as in the JAX package)")


def larcv_batch_to_dense(
    image: np.ndarray, image_size: Tuple[int, ...]
) -> np.ndarray:
    """[B, MaxVoxels, D+1] padded with -999 -> dense float32
    [B, *image_size, 1], channels-last (the JAX package's layout)."""
    _only_3d_images(image, "larcv_batch_to_dense")
    b = image.shape[0]
    out = np.zeros((b, *image_size, 1), np.float32)
    coords = image[..., :-1]
    vals = image[..., -1]
    valid = np.all(coords != -999.0, axis=-1) & (vals != -999.0)
    for bi in range(b):
        c = coords[bi][valid[bi]].astype(np.int64)
        out[(bi, *c.T, 0)] = vals[bi][valid[bi]]
    return out


def larcv_batch_to_pointcloud(
    image: np.ndarray, max_points: int,
    shuffle_rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """[B, MaxVoxels, D+1] -> (float32 points [B, max_points, D+1], bool
    mask [B, max_points]); a point's features are (coordinates..., value).
    An event with more valid voxels keeps its first ``max_points``, or,
    with ``shuffle_rng``, ``shuffle_rng.choice`` of them without
    replacement (the same draws as the JAX package's for the same
    generator)."""
    _only_3d_images(image, "larcv_batch_to_pointcloud")
    b, _, f = image.shape
    pts = np.zeros((b, max_points, f), np.float32)
    mask = np.zeros((b, max_points), bool)
    valid = np.all(image[..., :-1] != -999.0, axis=-1)
    for bi in range(b):
        idx = np.nonzero(valid[bi])[0]
        if shuffle_rng is not None and len(idx) > max_points:
            idx = shuffle_rng.choice(idx, max_points, replace=False)
        else:
            idx = idx[:max_points]
        pts[bi, :len(idx)] = image[bi, idx]
        mask[bi, :len(idx)] = True
    return pts, mask
