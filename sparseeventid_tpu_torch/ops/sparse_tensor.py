"""Fixed-capacity batched COO sparse tensor (PyTorch).

The layout is the JAX package's (``sparseeventid_tpu/ops/sparse_tensor.py``):

  * coords i32[B, N, D], sorted ascending by the row-major linear key per
    batch element, padding rows (coords -1, key ``INVALID_KEY``) last;
  * feats [B, N, C], zero at padding rows;
  * n_active i32[B];
  * grid_shape, a static tuple.

The linear key of the dune3d grid (1024*512*1280 = 6.7e8) fits in int32; it
is computed in int64 and stored as int32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Key of padding rows: int32 max, so an ascending sort packs padding last.
INVALID_KEY = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    coords: torch.Tensor  # i32[B, N, D]
    feats: torch.Tensor  # [B, N, C]
    n_active: torch.Tensor  # i32[B]
    grid_shape: Tuple[int, ...]

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[2]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def row_mask(self) -> torch.Tensor:
        """bool[B, N]: True at live rows (relies on the sorted invariant)."""
        idx = torch.arange(self.capacity, device=self.device, dtype=torch.int32)
        return idx[None, :] < self.n_active[:, None]

    def keys(self) -> torch.Tensor:
        """i32[B, N] linear keys (INVALID_KEY at padding)."""
        return linearize(self.coords, self.grid_shape)

    def with_feats(self, feats: torch.Tensor) -> "SparseTensor":
        """Same site set, new features."""
        return SparseTensor(self.coords, feats, self.n_active, self.grid_shape)


def linearize(coords: torch.Tensor, grid_shape: Tuple[int, ...]) -> torch.Tensor:
    """Row-major linear key per coordinate; INVALID_KEY where any coord < 0."""
    if int(np.prod(grid_shape)) >= 2**31:
        raise ValueError(f"grid {grid_shape} overflows int32 linearization")
    c = coords.long()
    key = c[..., 0]
    for d in range(1, len(grid_shape)):
        key = key * int(grid_shape[d]) + c[..., d]
    invalid = torch.any(coords < 0, dim=-1)
    return torch.where(invalid, INVALID_KEY, key).to(torch.int32)


def unlinearize(keys: torch.Tensor, grid_shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`linearize`; padding keys decode to -1 coords."""
    out = []
    rem = keys.long()
    for d in range(len(grid_shape) - 1, 0, -1):
        out.append(rem % int(grid_shape[d]))
        rem = rem // int(grid_shape[d])
    out.append(rem)
    coords = torch.stack(out[::-1], dim=-1).to(torch.int32)
    invalid = (keys == INVALID_KEY)[..., None]
    return torch.where(invalid, -1, coords).to(torch.int32)


def build_sparse_tensor(
    coords: torch.Tensor,
    feats: torch.Tensor,
    grid_shape: Tuple[int, ...],
    valid: torch.Tensor | None = None,
    capacity: int | None = None,
) -> SparseTensor:
    """SparseTensor from unsorted batched COO data.

    coords i32[B, N, D] (padding rows have a negative coordinate), feats
    [B, N, C], optional bool[B, N] ``valid`` overriding the padding test,
    optional ``capacity`` >= N to pad the rows to.  Rows are sorted per batch
    element by linear key; input sites are assumed unique.
    """
    coords = coords.to(torch.int32)
    if capacity is not None and capacity > coords.shape[1]:
        extra = capacity - coords.shape[1]
        coords = torch.nn.functional.pad(coords, (0, 0, 0, extra), value=-1)
        feats = torch.nn.functional.pad(feats, (0, 0, 0, extra))
        if valid is not None:
            valid = torch.nn.functional.pad(valid, (0, extra), value=False)
    key = linearize(coords, grid_shape)
    if valid is not None:
        key = torch.where(valid, key, INVALID_KEY)
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    coords_sorted = torch.gather(
        coords, 1, order[..., None].expand(-1, -1, coords.shape[2])
    )
    feats_sorted = torch.gather(
        feats, 1, order[..., None].expand(-1, -1, feats.shape[2])
    )
    live = key_sorted != INVALID_KEY
    n_active = live.sum(dim=-1).to(torch.int32)
    feats_sorted = torch.where(live[..., None], feats_sorted, 0)
    coords_sorted = torch.where(live[..., None], coords_sorted, -1)
    return SparseTensor(coords_sorted, feats_sorted, n_active, tuple(grid_shape))


def to_dense(st: SparseTensor) -> torch.Tensor:
    """SparseToDense: [B, *grid_shape, C], channels last (the JAX layout).
    Live rows add into their site's cell (a repeated key adds up); dead
    rows are dropped."""
    b = st.batch_size
    c = st.num_channels
    total = int(np.prod(st.grid_shape))
    mask = st.row_mask()
    slot = torch.where(mask, st.keys().long(), total)  # total: the drop slot
    feats = torch.where(mask[..., None], st.feats, 0)
    dense = torch.zeros((b, total + 1, c), dtype=st.feats.dtype, device=st.device)
    dense.scatter_add_(1, slot[..., None].expand(-1, -1, c), feats)
    return dense[:, :total].reshape((b, *st.grid_shape, c))


def from_dense(dense: torch.Tensor, capacity: int,
               grid_shape: Tuple[int, ...] | None = None) -> SparseTensor:
    """Testing helper: dense [B, *grid, C] -> SparseTensor of its nonzero
    sites in key order, the first ``capacity`` of each element."""
    if grid_shape is None:
        grid_shape = tuple(dense.shape[1:-1])
    b, c = dense.shape[0], dense.shape[-1]
    flat = dense.reshape(b, -1, c)
    cells = flat.shape[1]
    nz = (flat != 0).any(dim=-1)
    index = torch.arange(cells, dtype=torch.int32, device=dense.device)
    keys = torch.where(nz, index[None, :], INVALID_KEY)
    keys = torch.sort(keys, dim=-1).values[:, :capacity]
    coords = unlinearize(keys, tuple(grid_shape))
    rows = keys.clamp(0, cells - 1).long()
    feats = torch.gather(flat, 1, rows[..., None].expand(-1, -1, c))
    live = keys != INVALID_KEY
    feats = torch.where(live[..., None], feats, 0)
    return SparseTensor(coords, feats, live.sum(-1).to(torch.int32),
                        tuple(grid_shape))
