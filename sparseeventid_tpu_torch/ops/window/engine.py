"""Window-conv engine: plan construction on the device, the exact overflow
sidecar, and the forward convolutions built on the kernels
(JAX counterpart: ``sparseeventid_tpu/ops/pallas/window_engine.py``).

A ``WindowPlan`` is built once per site set and reused by every conv on it:
in-window pairs go through ``window_conv_apply``; the rare out-of-window
pairs are resolved exactly through a compacted (src, dst, k) list applied by
the sidecar, with a drop count if the list's static capacity is hit.

Only the forwards exist in this package so far; the backward kernels are
the next slice of the port, and calling a conv where autograd would need
its gradient raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..rulebook import _lookup, kernel_offsets
from ..sparse_tensor import SparseTensor
from .kernels import _ov_bound, overflow_apply, window_conv_apply, window_plan
from .query import (
    INVALID_QUERY,
    WindowTuning,
    _padded_table,
    _reverse_parts,
    compute_query_keys,
    compute_query_meta,
    compute_reverse_query_meta,
    compute_strided_query_keys,
    compute_strided_query_meta,
    key_deltas,
)
from .sidecar import overflow_apply_batched


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Plan of one site set for the windowed conv."""

    qmeta: torch.Tensor  # i32[B, 1+nw, M] base key + validity bitmask words
    start: torch.Tensor  # i32[B, n_tiles, K] window starts
    q_active: torch.Tensor  # i32[B] live rows on the query side
    ov_src: torch.Tensor  # i32[B, S] table row of an overflow pair
    ov_dst: torch.Tensor  # i32[B, S] output row
    ov_k: torch.Tensor  # i32[B, S] offset column
    ov_valid: torch.Tensor  # bool[B, S]
    ov_dropped: torch.Tensor  # i32[B] pairs lost to the static cap (should be 0)
    offsets: Tuple[Tuple[int, ...], ...]
    dkeys: Tuple[int, ...]  # key deltas in the TABLE grid (zeros: reverse)
    window_r: int  # the conv window rows the plan was built for
    q_bound: int | None = None  # static query-row bound (None = capacity)

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)


def _compact_overflow(
    keys: torch.Tensor,  # i32[B, N_table]
    qkeys: torch.Tensor,  # i32[B, M, K]
    uncovered: torch.Tensor,  # i32[B, M, K]
    cap: int,
):
    """Resolve uncovered queries exactly -> (src, dst, kk, valid, dropped).

    The uncovered flat positions are packed ascending at the front by a
    sort; the first ``cap`` are kept and looked up in the table keys."""
    b, m, k = qkeys.shape
    flat_q = qkeys.reshape(b, m * k)
    unc = (uncovered.reshape(b, m * k) != 0) & (flat_q != INVALID_QUERY)
    big = 2**30
    flat_idx = torch.arange(m * k, dtype=torch.int32, device=qkeys.device)
    composite = torch.where(unc, flat_idx[None, :], big)
    pos = torch.sort(composite, dim=1).values[:, :cap]
    live = pos < big
    pos = torch.where(live, pos, 0)
    q_ov = torch.where(
        live, torch.gather(flat_q, 1, pos.long()), INVALID_QUERY
    )
    total = unc.sum(dim=1).to(torch.int32)
    dropped = torch.clamp(total - cap, min=0)
    src, hit = _lookup(keys, q_ov)
    valid = hit & (q_ov != INVALID_QUERY)
    return src, (pos // k).to(torch.int32), (pos % k).to(torch.int32), valid, dropped


def build_submanifold_window_plan(
    st: SparseTensor,
    kernel_size,
    window_r: int,
    overflow_cap: int,
    q_bound: int | None = None,
) -> WindowPlan:
    """Plan of a submanifold conv (output sites == input sites).

    ``overflow_cap`` is the overflow list's width; the model's policy for
    it is ``ops.engine._overflow_cap``."""
    offs = kernel_offsets(kernel_size, centered=True)
    qkeys = compute_query_keys(st, offs)
    keys = st.keys()
    start, uncov = window_plan(
        _padded_table(keys), qkeys, st.n_active, window_r=window_r,
        table_cap=st.capacity,
    )
    src, dst, kk, valid, dropped = _compact_overflow(
        keys, qkeys, uncov, overflow_cap
    )
    return WindowPlan(
        compute_query_meta(st, offs), start, st.n_active, src, dst, kk,
        valid, dropped, offsets=tuple(map(tuple, offs.tolist())),
        dkeys=key_deltas(st.grid_shape, offs), window_r=window_r,
        q_bound=q_bound,
    )


def build_strided_window_plans(
    st: SparseTensor,
    skeleton: SparseTensor,
    stride,
    overflow_cap: int,
    q_bound: int | None = None,
    rev_q_bound: int | None = None,
    tuning: WindowTuning = WindowTuning(),
) -> Tuple[WindowPlan, WindowPlan]:
    """(forward, reverse) plans of a strided conv (filter == stride).

    forward: queries from output sites into the input table, with
             ``tuning.window_r_strided`` rows;
    reverse: one live column per INPUT row (its parent's key in the output
             table), with ``tuning.window_r`` rows; the backward uses it."""
    stride = tuple(int(s) for s in stride)
    offs = kernel_offsets(stride, centered=False)
    k = len(offs)
    r_fwd, r_rev = tuning.window_r_strided, tuning.window_r
    offsets = tuple(map(tuple, offs.tolist()))

    qkeys_f = compute_strided_query_keys(skeleton, st.grid_shape, stride, offs)
    keys_in = st.keys()
    start_f, uncov_f = window_plan(
        _padded_table(keys_in), qkeys_f, skeleton.n_active, window_r=r_fwd,
        table_cap=st.capacity,
    )
    src, dst, kk, val, drop = _compact_overflow(
        keys_in, qkeys_f, uncov_f, overflow_cap
    )
    fwd = WindowPlan(
        compute_strided_query_meta(skeleton, st.grid_shape, stride, offs),
        start_f, skeleton.n_active, src, dst, kk, val, drop,
        offsets=offsets, dkeys=key_deltas(st.grid_shape, offs),
        window_r=r_fwd, q_bound=q_bound,
    )

    pkey, off_id, rm = _reverse_parts(st, skeleton, stride)
    cols = torch.arange(k, dtype=torch.int32, device=st.device)
    qkeys_r = torch.where(
        (off_id[..., None] == cols) & rm[..., None], pkey[..., None],
        INVALID_QUERY,
    ).to(torch.int32)
    keys_out = skeleton.keys()
    start_r, uncov_r = window_plan(
        _padded_table(keys_out), qkeys_r, st.n_active, window_r=r_rev,
        table_cap=skeleton.capacity,
    )
    src_r, dst_r, kk_r, val_r, drop_r = _compact_overflow(
        keys_out, qkeys_r, uncov_r, overflow_cap
    )
    rev = WindowPlan(
        compute_reverse_query_meta(st, skeleton, stride, k), start_r,
        st.n_active, src_r, dst_r, kk_r, val_r, drop_r,
        offsets=offsets, dkeys=(0,) * k, window_r=r_rev, q_bound=rev_q_bound,
    )
    return fwd, rev


def _apply_overflow(out, table, w, plan: WindowPlan) -> torch.Tensor:
    """Sidecar onto the conv output, in place: the batched entry point for
    C > 1, the serial one for C == 1 (the initial 5^d conv), as in JAX."""
    args = (out, table, w, plan.ov_src, plan.ov_dst, plan.ov_k, plan.ov_valid,
            _ov_bound(plan.ov_valid))
    if table.shape[-1] != 1:
        return overflow_apply_batched(*args)
    return overflow_apply(*args)


def _forward_only(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "window-engine backward kernels land in slice 2 of the port "
            "(ROADMAP: the supervised train step); run the forward under "
            "torch.no_grad() or use framework.sparse_backend=xla"
        )


def _windowed(feats, keys, plan: WindowPlan, w) -> torch.Tensor:
    out = window_conv_apply(
        keys, feats, plan.qmeta, plan.start, w, plan.q_active, plan.dkeys,
        window_r=plan.window_r, q_bound=plan.q_bound,
    )
    return _apply_overflow(out, feats, w, plan)


def window_submanifold_conv(
    st: SparseTensor,
    plan: WindowPlan,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """Forward of ops.conv.submanifold_conv on the windowed engine."""
    _forward_only(st.feats, w, *(() if bias is None else (bias,)))
    out = _windowed(st.feats, st.keys(), plan, w.to(st.feats.dtype).contiguous())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return st.with_feats(torch.where(st.row_mask()[..., None], out, 0))


def window_strided_conv(
    st: SparseTensor,
    skeleton: SparseTensor,
    fwd_plan: WindowPlan,
    rev_plan: WindowPlan,
    w: torch.Tensor,
) -> SparseTensor:
    """Forward of ops.conv.strided_conv on the windowed engine; the reverse
    plan serves the backward."""
    del rev_plan
    _forward_only(st.feats, w)
    out = _windowed(
        st.feats, st.keys(), fwd_plan, w.to(st.feats.dtype).contiguous()
    )
    return skeleton.with_feats(
        torch.where(skeleton.row_mask()[..., None], out, 0)
    )

