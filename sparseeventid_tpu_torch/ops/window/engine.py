"""Window-conv engine: plan construction on the device, the exact overflow
sidecar, and the convolutions built on the kernels, forward and backward
(JAX counterpart: ``sparseeventid_tpu/ops/pallas/window_engine.py``).

A ``WindowPlan`` is built once per site set and reused by every conv on it:
in-window pairs go through ``window_conv_apply``; the rare out-of-window
pairs are resolved exactly through a compacted (src, dst, k) list applied by
the sidecar, with a drop count if the list's static capacity is hit.

The backwards need no scatter.  A submanifold conv's transpose is the
mirrored-offset conv on the same plan, a strided conv's walks the reverse
plan (one live offset column per input row); each has its own overflow
complement, applied by the dX and dW sidecars.  A deconvolution is the
strided conv between the same two site sets with the roles of its two
plans exchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..rulebook import _lookup, kernel_offsets
from ..sparse_tensor import SparseTensor
from .kernels import (
    _ov_bound,
    overflow_apply,
    overflow_dw,
    window_bwd_strided,
    window_bwd_subm,
    window_conv_apply,
    window_dw,
    window_gather,
    window_plan,
)
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
from .sidecar import overflow_apply_batched, overflow_dw_batched


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
    it is ``ops.engine.device_list_width``."""
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


def _overflow_dw(x, gy, src, dst, plan: WindowPlan) -> torch.Tensor:
    """dW sidecar over the plan's list with the given (src, dst) roles:
    float32 [K, C, CO].  Entry points split on C as the forward's do."""
    args = (x, gy, plan.num_offsets, src, dst, plan.ov_k, plan.ov_valid,
            _ov_bound(plan.ov_valid))
    if x.shape[-1] != 1:
        return overflow_dw_batched(*args)
    return overflow_dw(*args)


def _windowed(feats, keys, plan: WindowPlan, w) -> torch.Tensor:
    out = window_conv_apply(
        keys, feats, plan.qmeta, plan.start, w, plan.q_active, plan.dkeys,
        window_r=plan.window_r, q_bound=plan.q_bound,
    )
    return _apply_overflow(out, feats, w, plan)


def _mirror_perm(offsets) -> Tuple[int, ...]:
    """perm[k] = the slot of -offsets[k] (an involution for centered
    kernels)."""
    offs = [tuple(o) for o in offsets]
    lookup = {o: i for i, o in enumerate(offs)}
    return tuple(lookup[tuple(-v for v in o)] for o in offs)


class _SubmWindowConv(torch.autograd.Function):
    """Submanifold conv on one plan.  ``w`` is already in the feature type;
    the returned dW is rounded to that type, as the JAX package's is."""

    @staticmethod
    def forward(ctx, feats, w, keys, plan: WindowPlan):
        ctx.save_for_backward(feats, w, keys)
        ctx.plan = plan
        # the sidecar adds in place on the kernel's fresh output
        return _windowed(feats, keys, plan, w)

    @staticmethod
    def backward(ctx, gy):
        feats, w, keys = ctx.saved_tensors
        plan = ctx.plan
        need_dx, need_dw = ctx.needs_input_grad[:2]
        perm = _mirror_perm(plan.offsets)
        perm_t = torch.as_tensor(perm, device=w.device)
        gy = gy.to(feats.dtype).contiguous()
        w_t = w.transpose(1, 2)
        fused = feats.shape[-1] != 1
        dx = dw = None
        # The dX pass (fused or not) covers the MIRROR image of the forward
        # in-window set: pair (a -> b, k) iff the forward window covered
        # its twin (b -> a, perm[k]).  Its complement is therefore the
        # forward overflow list itself, each entry (src, dst, kk) standing
        # for the missing pair (dst <- src, perm[kk]), which adds
        # w_t[perm[kk]] gy[src] to dx[dst]: the list UNtransposed with
        # permuted weights.  Transposing the list instead would count twice
        # every pair whose twin was in-window.
        if fused:
            # one kernel gathers gy through the forward plan once and gives
            # both cotangents; its dW is indexed by perm[k]
            dx, dw = window_bwd_subm(
                keys, feats, gy, plan.qmeta, plan.start, w, plan.q_active,
                perm, plan.dkeys, window_r=plan.window_r, q_bound=plan.q_bound,
            )
        elif need_dx:
            # C == 1 (the initial conv): mirrored query columns, transposed
            # weights
            dx = window_conv_apply(
                keys, gy, plan.qmeta, plan.start, w_t.contiguous(),
                plan.q_active, plan.dkeys, kmap=perm,
                window_r=plan.window_r, q_bound=plan.q_bound,
            )
        if need_dx:
            dx = _apply_overflow(dx, gy, w_t[perm_t].contiguous(), plan)
        if need_dw and fused:
            # the mirrored set's complement adds x[dst] (outer) gy[src] to
            # dW[perm[kk]]: src and dst swapped, then the [perm] reorder
            dw = dw + _overflow_dw(feats, gy, plan.ov_dst, plan.ov_src, plan)
            dw = dw[perm_t]
        elif need_dw:
            # window_dw walks the forward in-window set, so the forward
            # list as it is completes it
            dw = window_dw(
                keys, feats, plan.qmeta, plan.start, gy, plan.q_active,
                plan.dkeys, window_r=plan.window_r, q_bound=plan.q_bound,
            )
            dw = dw + _overflow_dw(feats, gy, plan.ov_src, plan.ov_dst, plan)
        return (
            dx if need_dx else None,
            dw.to(w.dtype) if need_dw else None,
            None, None,
        )


class _StridedWindowConv(torch.autograd.Function):
    """Strided conv (filter == stride): the forward walks the forward plan,
    the backward the reverse plan over ``gy`` at the output sites."""

    @staticmethod
    def forward(ctx, feats, w, keys_in, keys_out, fwd: WindowPlan,
                rev: WindowPlan):
        ctx.save_for_backward(feats, w, keys_out)
        ctx.rev = rev
        return _windowed(feats, keys_in, fwd, w)

    @staticmethod
    def backward(ctx, gy):
        feats, w, keys_out = ctx.saved_tensors
        rev = ctx.rev
        need_dx, need_dw = ctx.needs_input_grad[:2]
        gy = gy.to(feats.dtype).contiguous()
        dx, dw = window_bwd_strided(
            keys_out, gy, feats, rev.qmeta, rev.start, w, rev.q_active,
            rev.dkeys, window_r=rev.window_r, q_bound=rev.q_bound,
        )
        if need_dx:
            dx = _apply_overflow(dx, gy, w.transpose(1, 2).contiguous(), rev)
        if need_dw:
            # reverse entries read gy[src] into input row dst
            dw = dw + _overflow_dw(feats, gy, rev.ov_dst, rev.ov_src, rev)
        return (
            dx if need_dx else None,
            dw.to(w.dtype) if need_dw else None,
            None, None, None, None,
        )


class _DeconvWindow(torch.autograd.Function):
    """Deconvolution (filter == stride) on the plans of the strided conv
    between the same two site sets, transposed: with (fwd, rev) =
    build_strided_window_plans(target_fine, st_coarse, stride), each fine
    row reads its parent coarse row through the reverse plan."""

    @staticmethod
    def forward(ctx, x_coarse, w, keys_fine, keys_coarse, fwd: WindowPlan,
                rev: WindowPlan):
        ctx.save_for_backward(x_coarse, w, keys_fine, keys_coarse)
        ctx.plans = (fwd, rev)
        return _windowed(x_coarse, keys_coarse, rev, w)

    @staticmethod
    def backward(ctx, gy):
        x_coarse, w, keys_fine, keys_coarse = ctx.saved_tensors
        fwd, rev = ctx.plans
        need_dx, need_dw = ctx.needs_input_grad[:2]
        gy = gy.to(x_coarse.dtype).contiguous()
        dxc = dw = None
        if need_dx:
            # the strided conv's forward walk over gy at the fine sites
            dxc = _windowed(gy, keys_fine, fwd, w.transpose(1, 2).contiguous())
        if need_dw:
            # two steps: the neighbour matrix of the reverse plan's
            # in-window pairs, then one float32 product with gy; the
            # reverse list completes it with x_coarse[src] (outer) gy[dst]
            k, c, co = w.shape
            g1 = window_gather(
                keys_coarse, x_coarse, rev.qmeta, rev.start, rev.q_active,
                rev.dkeys, window_r=rev.window_r,
            )
            dw = torch.einsum("bno,bnm->mo", gy.float(), g1.float())
            dw = dw.reshape(k, c, co)
            dw = dw + _overflow_dw(x_coarse, gy, rev.ov_src, rev.ov_dst, rev)
        return (
            dxc if need_dx else None,
            dw.to(w.dtype) if need_dw else None,
            None, None, None, None,
        )


def window_submanifold_conv(
    st: SparseTensor,
    plan: WindowPlan,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """ops.conv.submanifold_conv on the windowed engine."""
    out = _SubmWindowConv.apply(
        st.feats, w.to(st.feats.dtype).contiguous(), st.keys(), plan
    )
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
    """ops.conv.strided_conv on the windowed engine; the reverse plan serves
    the backward."""
    out = _StridedWindowConv.apply(
        st.feats, w.to(st.feats.dtype).contiguous(), st.keys(),
        skeleton.keys(), fwd_plan, rev_plan,
    )
    return skeleton.with_feats(
        torch.where(skeleton.row_mask()[..., None], out, 0)
    )


def window_deconv(
    st_coarse: SparseTensor,
    target: SparseTensor,
    fwd_plan: WindowPlan,
    rev_plan: WindowPlan,
    w: torch.Tensor,
) -> SparseTensor:
    """ops.conv.deconv on the windowed engine.  The plans come from
    ``build_strided_window_plans(target, st_coarse, stride)``: the FINE site
    set plays the input role, so the reverse plan walks fine -> coarse (the
    deconv's forward) and the forward plan serves dX."""
    out = _DeconvWindow.apply(
        st_coarse.feats, w.to(st_coarse.feats.dtype).contiguous(),
        target.keys(), st_coarse.keys(), fwd_plan, rev_plan,
    )
    return target.with_feats(torch.where(target.row_mask()[..., None], out, 0))
