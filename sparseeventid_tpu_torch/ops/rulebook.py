"""Rulebooks over the sorted site set: searchsorted lookups that map each
(output row, kernel offset) to its input row, as in the JAX package's
``ops/rulebook.py``.

A submanifold rulebook is a dense [B, N, K] gather table with a hit mask
(output sites == input sites, so each (site, offset) has at most one
partner).  A strided downsample builds the new site set
unique(coords // stride) and looks up out*stride + delta in the parent keys;
an upsample (deconvolution) looks up each fine site's parent.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from .sparse_tensor import INVALID_KEY, SparseTensor, linearize, unlinearize


@dataclasses.dataclass(frozen=True)
class Rulebook:
    """neighbor_idx i32[B, N, K] (0 at a miss), hit bool[B, N, K], and the
    static (K, D) offsets in row-major order (the weight layout W[K, C, CO])."""

    neighbor_idx: torch.Tensor
    hit: torch.Tensor
    offsets: Tuple[Tuple[int, ...], ...]

    @property
    def num_offsets(self) -> int:
        return self.neighbor_idx.shape[2]


def kernel_offsets(kernel_size: Sequence[int], centered: bool = True) -> np.ndarray:
    """Kernel offsets in row-major order: [-(k//2), k//2] per dim when
    ``centered`` (odd submanifold kernels), else [0, k) (strided)."""
    ranges = []
    for k in kernel_size:
        if centered:
            if k % 2 != 1:
                raise ValueError("submanifold kernels must be odd")
            ranges.append(range(-(k // 2), k // 2 + 1))
        else:
            ranges.append(range(k))
    return np.array(list(itertools.product(*ranges)), dtype=np.int32)


def _lookup(
    sorted_keys: torch.Tensor,  # i32[B, N] ascending, INVALID_KEY padding
    query_keys: torch.Tensor,  # i32[B, M]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched binary search -> (idx i32[B, M], hit bool[B, M])."""
    n = sorted_keys.shape[1]
    q = query_keys.to(sorted_keys.dtype).contiguous()
    pos = torch.searchsorted(sorted_keys.contiguous(), q, side="left")
    pos = pos.clamp(0, n - 1)
    found = (torch.gather(sorted_keys, 1, pos) == q) & (q != INVALID_KEY)
    return pos.to(torch.int32), found


def _offset_queries(q: torch.Tensor, grid_shape, row_mask) -> torch.Tensor:
    """Linear keys of coordinates q [B, N, K, D]; INVALID where out of the
    grid or at a dead row."""
    g = torch.as_tensor(grid_shape, dtype=torch.int32, device=q.device)
    in_bounds = torch.all((q >= 0) & (q < g), dim=-1)
    qk = linearize(q, grid_shape)
    return torch.where(in_bounds & row_mask[:, :, None], qk, INVALID_KEY)


def build_submanifold_rulebook(
    st: SparseTensor, kernel_size: Sequence[int]
) -> Rulebook:
    """Rulebook of a submanifold conv (output sites == input sites)."""
    offs = kernel_offsets(kernel_size, centered=True)
    b, n, _ = st.coords.shape
    k = offs.shape[0]
    q = st.coords[:, :, None, :] + torch.as_tensor(offs, device=st.device)
    qk = _offset_queries(q, st.grid_shape, st.row_mask())
    idx, hit = _lookup(st.keys(), qk.reshape(b, n * k))
    return Rulebook(
        idx.reshape(b, n, k), hit.reshape(b, n, k),
        offsets=tuple(map(tuple, offs.tolist())),
    )


def downsample_sites(
    st: SparseTensor,
    stride: Sequence[int],
    out_capacity: int | None = None,
    with_dropped: bool = False,
):
    """Site set of a strided conv: unique(coords // stride) on a grid of
    ceil(grid / stride), with zero-width feats.  If the unique count exceeds
    ``out_capacity`` (default: the input capacity) the highest keys are
    dropped; ``with_dropped`` also returns that per-event count."""
    stride = tuple(int(s) for s in stride)
    new_grid = tuple(-(-g // s) for g, s in zip(st.grid_shape, stride))
    n_out_cap = out_capacity or st.capacity
    child = torch.div(
        st.coords, torch.as_tensor(stride, dtype=torch.int32, device=st.device),
        rounding_mode="floor",
    )
    child_keys = torch.where(
        st.row_mask(), linearize(child, new_grid), INVALID_KEY
    )
    sk, _ = torch.sort(child_keys, dim=-1)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    first &= sk != INVALID_KEY
    out_keys, _ = torch.sort(torch.where(first, sk, INVALID_KEY), dim=-1)
    out_keys = out_keys[:, :n_out_cap]
    if out_keys.shape[1] < n_out_cap:
        out_keys = torch.nn.functional.pad(
            out_keys, (0, n_out_cap - out_keys.shape[1]), value=INVALID_KEY
        )
    total = first.sum(dim=-1).to(torch.int32)
    n_out = torch.clamp(total, max=n_out_cap).to(torch.int32)
    skeleton = SparseTensor(
        coords=unlinearize(out_keys, new_grid),
        feats=torch.zeros(
            (st.batch_size, n_out_cap, 0), dtype=st.feats.dtype,
            device=st.device,
        ),
        n_active=n_out,
        grid_shape=new_grid,
    )
    if with_dropped:
        return skeleton, torch.clamp(total - n_out_cap, min=0)
    return skeleton


def build_downsample_rulebook(
    st: SparseTensor, skeleton: SparseTensor, stride: Sequence[int]
) -> Rulebook:
    """Gather table: out_site * stride + delta looked up in the parent keys."""
    stride = tuple(int(s) for s in stride)
    offs = kernel_offsets(stride, centered=False)
    b, n_out, _ = skeleton.coords.shape
    k = offs.shape[0]
    dev = st.device
    q = (
        skeleton.coords[:, :, None, :] * torch.as_tensor(stride, device=dev)
        + torch.as_tensor(offs, device=dev)
    ).to(torch.int32)
    qk = _offset_queries(q, st.grid_shape, skeleton.row_mask())
    idx, hit = _lookup(st.keys(), qk.reshape(b, n_out * k))
    return Rulebook(
        idx.reshape(b, n_out, k), hit.reshape(b, n_out, k),
        offsets=tuple(map(tuple, offs.tolist())),
    )


def build_upsample(
    st_coarse: SparseTensor, target: SparseTensor, stride: Sequence[int]
) -> Rulebook:
    """Rulebook of a deconvolution (filter == stride) onto a supplied finer
    site set: each target site t reads coarse site t // stride through the
    weight slice of offset t % stride.  K = prod(stride) columns, at most
    one of them live per target row."""
    stride = tuple(int(s) for s in stride)
    offs = kernel_offsets(stride, centered=False)
    k = offs.shape[0]
    b, n, _ = target.coords.shape
    mask = target.row_mask()
    stride_t = torch.as_tensor(stride, dtype=torch.int32, device=target.device)
    parent = torch.div(target.coords, stride_t, rounding_mode="floor")
    rem = target.coords - parent * stride_t
    pkeys = torch.where(
        mask, linearize(parent, st_coarse.grid_shape), INVALID_KEY
    )
    idx, hit = _lookup(st_coarse.keys(), pkeys)
    off_id = rem[..., 0]
    for d in range(1, rem.shape[-1]):
        off_id = off_id * stride[d] + rem[..., d]
    slot = off_id[..., None] == torch.arange(k, device=target.device)
    return Rulebook(
        idx[:, :, None].expand(b, n, k).contiguous(),
        slot & hit[:, :, None] & mask[:, :, None],
        offsets=tuple(map(tuple, offs.tolist())),
    )
