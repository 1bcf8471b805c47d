"""Query helpers of the sorted-window conv engine: the constants, window
sizes, query keys and packed query meta that the plan and conv kernels
consume (JAX counterpart: ``ops/pallas/window_conv.py:48-524``).

Neighbour queries ``q = key + delta_key(offset)`` are monotone per offset
over the sorted site set, so the matches of one 128-query tile lie in a
short run of table rows.  A plan gives each (tile, offset) the start of an
R-row window; the conv kernel searches only that window, and the rare
matches outside it go to the overflow sidecar list.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..sparse_tensor import INVALID_KEY, SparseTensor, linearize

TILE_T = 128  # queries per plan tile; ``start`` is indexed by m // TILE_T
ANCHOR_A = 128  # anchor stride of the plan's coarse pass
PLAN_R = 384  # rows of the plan's exact-position window
START_ALIGN = 16  # window starts are multiples of this

# Sentinel for invalid queries: never a key (keys are >= 0) nor INVALID_KEY.
INVALID_QUERY = -2


@dataclasses.dataclass(frozen=True)
class WindowTuning:
    """Window rows of the conv kernels, per site set.  The plan and the conv
    of one site set must use the same value."""

    window_r: int = 160  # series convs, shallow levels; reverse plans
    window_r_strided: int = 320  # strided forward plans
    window_r_initial: int = 176  # the 5^d initial conv
    window_r_deep: int = 160  # series convs from window_r_deep_from on
    window_r_deep_from: int = 3

    @classmethod
    def from_config(cls, tuning) -> "WindowTuning":
        """Resolve ``framework.tuning``: fields that are set override the
        defaults, and the deep window is never below the shallow one."""
        set_fields = {
            f.name: getattr(tuning, f.name)
            for f in dataclasses.fields(cls)
            if getattr(tuning, f.name, None) is not None
        }
        t = cls(**set_fields)
        return dataclasses.replace(
            t, window_r_deep=max(t.window_r, t.window_r_deep)
        )

    def for_level(self, level: int) -> int:
        """Series-conv window rows for an encoder level."""
        if level < self.window_r_deep_from:
            return self.window_r
        return self.window_r_deep


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _delta_keys(grid, offsets) -> np.ndarray:
    offs = np.asarray(offsets, np.int64)
    g = [int(x) for x in grid]
    d = offs[:, 0]
    for dim in range(1, offs.shape[1]):
        d = d * g[dim] + offs[:, dim]
    return d


def key_deltas(grid, offsets) -> Tuple[int, ...]:
    """Per-offset key deltas: linearize(c + off) = linearize(c) + delta."""
    return tuple(int(v) for v in _delta_keys(grid, offsets))


def compute_query_keys(st: SparseTensor, offsets: np.ndarray) -> torch.Tensor:
    """q[b, n, k] = linearize(coords + offsets[k]) or INVALID_QUERY."""
    offs = np.asarray(offsets, np.int64)
    g = [int(x) for x in st.grid_shape]
    dkey = torch.as_tensor(_delta_keys(g, offs), device=st.device)
    qk = st.keys().long()[:, :, None] + dkey
    valid = st.row_mask()[:, :, None]
    for d in range(offs.shape[1]):  # 2 on a plain 2-D grid
        cd = st.coords[..., d][:, :, None] + torch.as_tensor(
            offs[:, d], device=st.device
        )
        valid = valid & (cd >= 0) & (cd < g[d])
    return torch.where(valid, qk, INVALID_QUERY).to(torch.int32)


def _strided_base(coords, parent_grid, stride) -> torch.Tensor:
    """int64 linearize(c * stride) in the parent grid (garbage at padding)."""
    c = coords.long()
    base = c[..., 0] * int(stride[0])
    for d in range(1, coords.shape[-1]):
        base = base * int(parent_grid[d]) + c[..., d] * int(stride[d])
    return base


def compute_strided_query_keys(
    skeleton: SparseTensor, parent_grid, stride, offsets: np.ndarray,
) -> torch.Tensor:
    """Downsample queries: linearize(out*stride + delta) in the PARENT grid,
    or INVALID_QUERY."""
    offs = np.asarray(offsets, np.int64)
    g = [int(x) for x in parent_grid]
    s = [int(x) for x in stride]
    dev = skeleton.device
    dkey = torch.as_tensor(_delta_keys(g, offs), device=dev)
    qk = _strided_base(skeleton.coords, g, s)[:, :, None] + dkey
    valid = skeleton.row_mask()[:, :, None]
    for d in range(offs.shape[1]):
        cd = skeleton.coords[..., d][:, :, None].long() * s[d] + torch.as_tensor(
            offs[:, d], device=dev
        )
        valid = valid & (cd >= 0) & (cd < g[d])
    return torch.where(valid, qk, INVALID_QUERY).to(torch.int32)


def meta_words(k: int) -> int:
    """Validity-bitmask words in a query meta array (32 offsets per word)."""
    return _cdiv(k, 32)


def _bit(bit: int) -> int:
    """int32 value with only ``bit`` set (two's complement at bit 31)."""
    return -(2**31) if bit == 31 else 1 << bit


def _meta_from_base(base, rm, per_k_valid, k) -> torch.Tensor:
    """Pack [B, M] base keys + per-offset validity into i32[B, 1+nw, M].

    Row 0 is the base key (INVALID_QUERY at dead rows); row 1+w holds bit
    ``kk % 32`` of word ``kk // 32`` set iff query ``kk`` is live.  The
    kernels recompute q = base + dkeys[kk] where the bit is set."""
    words = []
    for wi in range(meta_words(k)):
        acc = torch.zeros(rm.shape, dtype=torch.int32, device=rm.device)
        for bit in range(min(32, k - 32 * wi)):
            acc = acc | torch.where(per_k_valid(wi * 32 + bit), _bit(bit), 0).to(
                torch.int32
            )
        words.append(acc)
    base = torch.where(rm, base, INVALID_QUERY).to(torch.int32)
    return torch.stack([base] + words, dim=1)


def _dim_range_masks(coords, offs, g, scale=None):
    """dim_ok[d][offset value] -> bool [B, M] (None = always true)."""
    dim_ok = []
    for d in range(offs.shape[1]):
        s = 1 if scale is None else int(scale[d])
        dd = {}
        for v in sorted({int(x) for x in offs[:, d]}):
            if s == 1 and v == 0:
                dd[v] = None  # the site's own coordinate is in range
            else:
                cd = coords[..., d].long() * s + v
                dd[v] = (cd >= 0) & (cd < g[d])
        dim_ok.append(dd)
    return dim_ok


def _offset_validity(rm, dim_ok, offs):
    def valid(kk):
        v = rm
        for d in range(offs.shape[1]):
            m = dim_ok[d][int(offs[kk, d])]
            if m is not None:
                v = v & m
        return v

    return valid


def compute_query_meta(st: SparseTensor, offsets: np.ndarray) -> torch.Tensor:
    """[B, 1+nw, M] query meta of a submanifold plan; pair with
    key_deltas(st.grid_shape, offsets)."""
    offs = np.asarray(offsets, np.int64)
    g = [int(x) for x in st.grid_shape]
    rm = st.row_mask()
    dim_ok = _dim_range_masks(st.coords, offs, g)
    return _meta_from_base(
        st.keys(), rm, _offset_validity(rm, dim_ok, offs), len(offs)
    )


def compute_strided_query_meta(
    skeleton: SparseTensor, parent_grid, stride, offsets: np.ndarray,
) -> torch.Tensor:
    """[B, 1+nw, M] meta of forward downsample queries: base =
    linearize(c*stride) in the PARENT grid; pair with
    key_deltas(parent_grid, offsets)."""
    offs = np.asarray(offsets, np.int64)
    g = [int(x) for x in parent_grid]
    s = [int(x) for x in stride]
    rm = skeleton.row_mask()
    base = _strided_base(skeleton.coords, g, s)
    dim_ok = _dim_range_masks(skeleton.coords, offs, g, scale=s)
    return _meta_from_base(
        base, rm, _offset_validity(rm, dim_ok, offs), len(offs)
    )


def _reverse_parts(st: SparseTensor, skeleton: SparseTensor, stride):
    """(parent key i32[B, N], intra-cell offset id [B, N], live rows)."""
    stride_t = torch.as_tensor(stride, dtype=torch.int32, device=st.device)
    parent = torch.div(st.coords, stride_t, rounding_mode="floor")
    pkey = linearize(parent, skeleton.grid_shape)
    rem = st.coords - parent * stride_t
    off_id = rem[..., 0]
    for d in range(1, rem.shape[-1]):
        off_id = off_id * int(stride[d]) + rem[..., d]
    rm = st.row_mask() & (pkey != INVALID_KEY)
    return pkey, off_id, rm


def compute_reverse_query_meta(
    st: SparseTensor, skeleton: SparseTensor, stride, k: int
) -> torch.Tensor:
    """[B, 2, M] meta of reverse downsample queries: one live offset column
    per input row (its parent's key at the row's intra-cell offset).  Pair
    with dkeys = (0,) * k."""
    if k > 32:
        raise ValueError(f"reverse meta packs offsets into one word (k={k})")
    pkey, off_id, rm = _reverse_parts(st, skeleton, stride)
    one = torch.ones_like(off_id)
    word = torch.where(rm, torch.bitwise_left_shift(one, off_id), 0)
    base = torch.where(rm, pkey, INVALID_QUERY)
    return torch.stack([base, word], dim=1).to(torch.int32)


def materialize_qkeys(qmeta: torch.Tensor, dkeys) -> torch.Tensor:
    """[B, K, M] query keys reconstructed from packed meta (for tests and
    debugging; the kernels never materialize it)."""
    base = qmeta[:, 0, :].long()
    cols = []
    for kk in range(len(dkeys)):
        word = qmeta[:, 1 + kk // 32, :]
        live = (word & _bit(kk % 32)) != 0
        cols.append(torch.where(live, base + int(dkeys[kk]), INVALID_QUERY))
    return torch.stack(cols, dim=1).to(torch.int32)


def _pad_rows(x: torch.Tensor, n_to: int, fill) -> torch.Tensor:
    n = x.shape[1]
    if n == n_to:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, n_to - n]
    return torch.nn.functional.pad(x, pad, value=fill)


def _padded_table(keys: torch.Tensor) -> torch.Tensor:
    """Keys padded so any plan window [start, start + PLAN_R) is in range."""
    npad = _round_up(keys.shape[1], ANCHOR_A) + PLAN_R
    return _pad_rows(keys, npad, INVALID_KEY)


def _live_tiles(n_active: torch.Tensor, m: int) -> torch.Tensor:
    """i32[B]: query tiles with at least one live row."""
    n_tiles = _cdiv(m, TILE_T)
    return torch.clamp(
        (n_active.to(torch.int32) + TILE_T - 1) // TILE_T, max=n_tiles
    )


def conv_max_start(table_cap: int, window_r: int) -> int:
    """Largest window start the conv may use: windows must satisfy
    start + r <= max(round16(cap), round16(r))."""
    length = max(_round_up(table_cap, 16), _round_up(window_r, 16))
    return length - window_r
