"""Wrappers of the window-engine CUDA kernels, each with its plain PyTorch
version beside it.

A wrapper dispatches on the device of its tensors: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (built from ``csrc/`` on first
use), and a failed build or launch raises.  There is no fallback from the
kernel to the plain version.  Each wrapper counts its kernel launches in
``<wrapper>.launches`` and each plain version its calls in
``<plain>.calls``, plain integers that a caller may reset.

JAX counterparts (``sparseeventid_tpu/ops/pallas/window_conv.py``):
``window_plan`` (:607), ``window_conv_apply`` (:993), ``window_dw`` (:1264),
``window_bwd_subm`` (:1365), ``window_bwd_strided`` (:1506),
``window_gather`` (:1608), ``overflow_apply`` (:1783), ``overflow_dw``
(:1881) and ``_ov_bound`` (:1722).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..sparse_tensor import INVALID_KEY
from . import _native
from .query import (
    ANCHOR_A,
    INVALID_QUERY,
    PLAN_R,
    START_ALIGN,
    TILE_T,
    _cdiv,
    _live_tiles,
    _pad_rows,
    _round_up,
    conv_max_start,
)

_BIG = 2**30  # "no candidate" sentinel of the plan minima


def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no window kernel for device {dev}")


def _check(t: torch.Tensor, name: str, dtype=None, ndim=None) -> None:
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _float_dtype(t: torch.Tensor, what: str) -> torch.dtype:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")
    return t.dtype


def _offset_args(dkeys, kmap):
    """(K, host int arrays of the key deltas and the slot -> column map)."""
    k = len(dkeys)
    cols = list(range(k)) if kmap is None else [int(x) for x in kmap]
    arr = ctypes.c_int * k
    return k, arr(*[int(d) for d in dkeys]), arr(*cols)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# window_plan
# --------------------------------------------------------------------------

def window_plan_plain(
    padded_keys: torch.Tensor,  # i32[B, Npad] sorted, INVALID_KEY padded
    qkeys: torch.Tensor,  # i32[B, N, K]
    n_active: torch.Tensor,  # i32[B] live rows on the query side
    window_r: int,
    table_cap: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`window_plan` (the same result, bit for bit).

    The TPU kernel's window compares become binary searches: on the sorted
    keys, #(window keys < q) is the lower bound of q clamped to the window."""
    window_plan_plain.calls += 1
    b, npad = padded_keys.shape
    table_cap = npad if table_cap is None else table_cap
    _, n, k = qkeys.shape
    n_tiles = _cdiv(n, TILE_T)
    max_start = conv_max_start(table_cap, window_r)
    keys = padded_keys.long().contiguous()
    q = _pad_rows(qkeys, n_tiles * TILE_T, INVALID_QUERY).long()
    qf = q.reshape(b, -1)
    anchors = keys[:, ::ANCHOR_A][:, : npad // ANCHOR_A]
    anchors = torch.where(anchors == INVALID_KEY, 2**40, anchors).contiguous()
    shape = (b, n_tiles, TILE_T, k)
    bl = torch.searchsorted(anchors, qf, right=True).reshape(shape) - 1
    q = q.reshape(shape)
    valid = q >= 0
    pos_blk = bl * ANCHOR_A
    coarse = torch.where(valid & (bl >= 0), pos_blk, _BIG).amin(dim=2)
    coarse = coarse.clamp(max=npad - PLAN_R)
    coarse = coarse.clamp(max=(max_start // ANCHOR_A) * ANCHOR_A).clamp(min=0)
    c = coarse[:, :, None, :]
    cov = (bl >= 0) & (pos_blk >= c) & (pos_blk + ANCHOR_A <= c + PLAN_R)
    lb = torch.searchsorted(keys, qf).reshape(shape)
    pos = torch.minimum(torch.maximum(lb, c), c + PLAN_R)
    at = torch.gather(keys, 1, pos.clamp(max=npad - 1).reshape(b, -1))
    hit = (pos < c + PLAN_R) & (at.reshape(shape) == q)
    live_min = torch.where(valid & cov & hit, pos, _BIG).amin(dim=2)
    start = (live_min // START_ALIGN) * START_ALIGN
    start = torch.minimum(start, coarse + PLAN_R - window_r)
    start = torch.maximum(start, coarse).clamp(max=max_start)
    s = start[:, :, None, :]
    inwin = hit & (pos >= s) & (pos < s + window_r)
    uncov = valid & (bl >= 0) & ~inwin & (hit | ~cov)
    alive = (
        torch.arange(n_tiles, device=keys.device)[None, :]
        < _live_tiles(n_active, n)[:, None]
    )
    start = torch.where(alive[..., None], start, 0).to(torch.int32)
    uncov = (uncov & alive[:, :, None, None]).to(torch.int32)
    return start, uncov.reshape(b, n_tiles * TILE_T, k)[:, :n]


window_plan_plain.calls = 0


def _plan_group(sms: int, b: int, n_tiles: int, k: int) -> int:
    """Offsets one block of :func:`window_plan` takes (its 8 warps share
    them): up to 32, halved while the grid of (b, tile, group) blocks is
    under four blocks an SM, down to 8 (one offset a warp)."""
    g = min(k, 32)
    while g > 8 and _cdiv(k, g) * n_tiles * b < 4 * sms:
        g = max(8, _cdiv(g, 2))
    return max(g, 1)


def window_plan(
    padded_keys: torch.Tensor,  # i32[B, Npad] sorted, INVALID_KEY padded
    qkeys: torch.Tensor,  # i32[B, N, K]
    n_active: torch.Tensor,  # i32[B] live rows on the query side
    window_r: int,
    table_cap: int | None = None,  # unpadded table length (conv bound)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (start i32[B, n_tiles, K], uncovered i32[B, N, K]).

    ``padded_keys`` must reach every plan window: Npad >= round128(N_table)
    + PLAN_R (``query._padded_table``)."""
    if not _use_kernel(padded_keys, qkeys, n_active):
        return window_plan_plain(
            padded_keys, qkeys, n_active, window_r, table_cap
        )
    b, npad = padded_keys.shape
    table_cap = npad if table_cap is None else table_cap
    _, n, k = qkeys.shape
    _check(padded_keys, "padded_keys", torch.int32, 2)
    _check(qkeys, "qkeys", torch.int32, 3)
    _check(n_active, "n_active", torch.int32, 1)
    if npad % ANCHOR_A or npad < PLAN_R:
        raise ValueError(f"padded_keys length {npad} is not a plan table")
    n_tiles = _cdiv(n, TILE_T)
    start = torch.empty((b, n_tiles, k), dtype=torch.int32, device=qkeys.device)
    uncov = torch.empty((b, n, k), dtype=torch.int32, device=qkeys.device)
    sms = torch.cuda.get_device_properties(qkeys.device).multi_processor_count
    fn = _native.lib("window_plan").seid_window_plan
    err = fn(_ptr(padded_keys), npad, _ptr(qkeys), n, k, _ptr(n_active),
             _ptr(start), _ptr(uncov), b, n_tiles, int(window_r),
             conv_max_start(table_cap, window_r),
             _plan_group(sms, b, n_tiles, k), _stream(qkeys))
    window_plan.launches += 1
    _native.check(err, "window_plan")
    return start, uncov


window_plan.launches = 0


# --------------------------------------------------------------------------
# window_conv_apply
# --------------------------------------------------------------------------

def _query_rows_bound(m: int, q_bound: int | None) -> int:
    """Rows of the query side the conv may produce (the rest are 0)."""
    if q_bound is None:
        return m
    return min(m, _round_up(q_bound, TILE_T))


def _matched_rows(keys, qmeta, start, q_active, dkeys, kmap, window_r,
                  q_bound):
    """Per kernel slot, the in-window match of every query row: yields
    (slot, found bool[B, M], table row i64[B, M], 0 where not found).  The
    one plain definition of the pair set the kernels compute; its
    complement is the plan's overflow list."""
    _, _, m = qmeta.shape
    n_in = keys.shape[1]
    k = len(dkeys)
    cols = list(range(k)) if kmap is None else [int(x) for x in kmap]
    mb = _query_rows_bound(m, q_bound)
    rows_m = torch.arange(m, device=keys.device)
    tile = rows_m // TILE_T
    row_ok = (tile[None, :] < _live_tiles(q_active, mb)[:, None]) & (
        rows_m < mb
    )[None, :]
    keys64 = keys.long().contiguous()
    base = qmeta[:, 0, :].long()
    for kk, col in enumerate(cols):
        word = qmeta[:, 1 + col // 32, :]
        live = ((word >> (col % 32)) & 1) != 0
        q = base + int(dkeys[col])
        s = start[:, tile, col].long()
        lb = torch.searchsorted(keys64, q.contiguous())
        at = torch.gather(keys64, 1, lb.clamp(max=n_in - 1))
        found = (
            live & row_ok & (lb >= s) & (lb < s + window_r) & (lb < n_in)
            & (at == q)
        )
        yield kk, found, torch.where(found, lb, 0)


def _gather_matched(table, found, rows) -> torch.Tensor:
    """float32 [B, M, C]: the matched table rows, 0 where not found."""
    c = table.shape[-1]
    g = torch.gather(table, 1, rows[..., None].expand(-1, -1, c)).float()
    return torch.where(found[..., None], g, 0.0)


def window_conv_apply_plain(
    keys: torch.Tensor,
    feats: torch.Tensor,
    qmeta: torch.Tensor,
    start: torch.Tensor,
    w: torch.Tensor,
    q_active: torch.Tensor,
    dkeys: Sequence[int],
    kmap: Sequence[int] | None = None,
    *,
    window_r: int,
    q_bound: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`window_conv_apply`: per offset, a lookup of
    every query's key, kept only where the row lies in the query tile's
    window, then a gather and a float32 matmul."""
    window_conv_apply_plain.calls += 1
    b, _, m = qmeta.shape
    acc = torch.zeros((b, m, w.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for kk, found, rows in _matched_rows(keys, qmeta, start, q_active, dkeys,
                                         kmap, window_r, q_bound):
        acc += torch.matmul(_gather_matched(feats, found, rows), w[kk].float())
    return acc.to(feats.dtype)


window_conv_apply_plain.calls = 0


def _conv_groups(sms: int, b: int, m: int, k: int, c: int, co: int,
                 min_steps: int = 13) -> int:
    """Blocks (one thread-block cluster) that share a query tile's offsets
    in the tensor-core route of :func:`window_conv_apply`, so that the deep
    levels, whose few tiles each chain ceil(K * C / 64) steps, spread over
    the card: a power of two up to 8 (such clusters pack a GPC's SMs), as
    many as leave every block at least ``min_steps`` steps (13: a block's
    fixed cost is about 6) and keep the (tile, 192-column slab, group) grid
    within 13 blocks an SM.  The host does not know the live tiles; these
    limits were chosen from a sweep of every level of both recipes on the
    H100 (PERF.md).  1 on the C == 1 route."""
    if c == 1 and co <= 32:
        return 1
    steps = _cdiv(k * c, 64)
    blocks = b * _cdiv(m, TILE_T) * _cdiv(co, 192)
    g = 1
    while (2 * g <= 8 and 2 * g * min_steps <= steps
           and blocks * 2 * g <= 13 * sms):
        g *= 2
    return g


def window_conv_apply(
    keys: torch.Tensor,  # i32[B, N_in] sorted keys of the table site set
    feats: torch.Tensor,  # [B, N_in, C] table features
    qmeta: torch.Tensor,  # i32[B, 1+nw, M] packed query meta
    start: torch.Tensor,  # i32[B, n_tiles, K] from window_plan
    w: torch.Tensor,  # [K, C, CO], the feature type
    q_active: torch.Tensor,  # i32[B] live rows on the query side
    dkeys: Sequence[int],  # per-offset key deltas (query.key_deltas)
    kmap: Sequence[int] | None = None,  # kernel slot -> query column
    *,
    window_r: int,
    q_bound: int | None = None,
) -> torch.Tensor:
    """-> [B, M, CO]: the in-window contributions only.  Matches outside
    [start, start + window_r) belong to the plan's overflow list and are
    left to the sidecar.  ``window_r`` must be the plan's."""
    if not _use_kernel(keys, feats, qmeta, start, w, q_active):
        return window_conv_apply_plain(
            keys, feats, qmeta, start, w, q_active, dkeys, kmap,
            window_r=window_r, q_bound=q_bound,
        )
    dtype = _float_dtype(feats, "window_conv_apply")
    b, nw1, m = qmeta.shape
    n_in, c = feats.shape[1], feats.shape[2]
    co = w.shape[-1]
    k, dk, cols = _offset_args(dkeys, kmap)
    _check(keys, "keys", torch.int32, 2)
    _check(feats, "feats", dtype, 3)
    _check(qmeta, "qmeta", torch.int32, 3)
    _check(start, "start", torch.int32, 3)
    _check(w, "w", dtype, 3)
    _check(q_active, "q_active", torch.int32, 1)
    if w.shape[:2] != (k, c) or keys.shape != (b, n_in):
        raise ValueError("window_conv_apply: inconsistent shapes")
    if start.shape[2] != k or start.shape[1] < _cdiv(m, TILE_T):
        raise ValueError(f"start {tuple(start.shape)} does not fit M={m}, K={k}")
    out = torch.empty((b, m, co), dtype=dtype, device=feats.device)
    name = "seid_window_conv_bf16" if dtype == torch.bfloat16 else "seid_window_conv_f32"
    fn = getattr(_native.lib("window_conv"), name)
    sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
    err = fn(_ptr(keys), n_in, _ptr(feats), c, _ptr(qmeta), nw1 - 1, m,
             _ptr(start), start.shape[1], k, _ptr(w), co, _ptr(q_active),
             _query_rows_bound(m, q_bound), int(window_r), _ptr(out),
             dk, cols, b, _conv_groups(sms, b, m, k, c, co), _stream(feats))
    window_conv_apply.launches += 1
    _native.check(err, "window_conv_apply")
    return out


window_conv_apply.launches = 0


# --------------------------------------------------------------------------
# window_bwd_strided / window_bwd_subm: dX and dW through the backward plan
# --------------------------------------------------------------------------

def window_bwd_strided_plain(
    keys_out, gy, feats, rq, rs, w, r_active, dkeys, kmap=None, *,
    window_r: int, q_bound: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`window_bwd_strided`: per offset one gather of
    the matched ``gy`` rows, used for dx (a float32 matmul with w[k]^T,
    summed over k, cast once) and for dw (a float32 einsum with x)."""
    window_bwd_strided_plain.calls += 1
    b, _, m = rq.shape
    k, c, co = w.shape
    x32 = feats.float()
    dx = torch.zeros((b, m, c), dtype=torch.float32, device=feats.device)
    dw = torch.zeros((k, c, co), dtype=torch.float32, device=feats.device)
    for kk, found, rows in _matched_rows(keys_out, rq, rs, r_active, dkeys,
                                         kmap, window_r, q_bound):
        g = _gather_matched(gy, found, rows)
        dx += torch.matmul(g, w[kk].float().t())
        dw[kk] = torch.einsum("bmc,bmo->co", x32, g)
    return dx.to(feats.dtype), dw


window_bwd_strided_plain.calls = 0

_SCRATCH_BYTES = 64 << 20  # most float32 partials a dW kernel keeps
_BWD_PIECE = 32  # dw rows and columns a warp of the backward's dW owns


def _bwd_dw_parts(sms: int, b: int, m: int, k: int, c: int, co: int) -> int:
    """Warps that share out the live query tiles of
    :func:`window_bwd_strided`'s dW for each (offset, 32 x 32) piece of dw,
    each writing its partial once to a row of the float32 scratch: about 24
    warps an SM in all (three blocks of 8), no more parts than query tiles,
    and the scratch within ``_SCRATCH_BYTES``.  The count fixes the
    summation order, so dw repeats bit for bit on one card."""
    pieces = k * _cdiv(c, _BWD_PIECE) * _cdiv(co, _BWD_PIECE)
    budget = _SCRATCH_BYTES // (4 * k * c * co)
    return max(1, min(b * _cdiv(m, TILE_T), _cdiv(24 * sms, pieces), budget))


def _bwd_weights(w: torch.Tensor, perm: Sequence[int] | None = None
                 ) -> torch.Tensor:
    """The dX kernel's weights: w[perm] (the submanifold twin), transposed
    to a contiguous [K, CO, C]."""
    if perm is not None:
        w = w[torch.as_tensor([int(p) for p in perm], device=w.device)]
    return w.transpose(1, 2).contiguous()


def window_bwd_strided(
    keys_out: torch.Tensor,  # i32[B, N_out] sorted keys of the gy table
    gy: torch.Tensor,  # [B, N_out, CO] output cotangent, the feature type
    feats: torch.Tensor,  # [B, N_in, C] forward input
    rq: torch.Tensor,  # i32[B, 1+nw, N_in] query meta, one query per INPUT row
    rs: torch.Tensor,  # i32[B, n_tiles, K] window starts
    w: torch.Tensor,  # [K, C, CO], the feature type
    r_active: torch.Tensor,  # i32[B] live input rows
    dkeys: Sequence[int],
    kmap: Sequence[int] | None = None,
    *,
    window_r: int,
    q_bound: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dx [B, N_in, C] in the feature type, dw float32 [K, C, CO] summed
    over the batch) over the in-window pairs of the plan:
    dx[t] = sum_k w[k] gy[n(t, k)],  dw[k] = sum_t x[t] (outer) gy[n(t, k)].
    Dead tiles and rows past ``q_bound`` give dx = 0.  ``window_r`` must be
    the plan's.  On the card both are the same bits on every run."""
    if not _use_kernel(keys_out, gy, feats, rq, rs, w, r_active):
        return window_bwd_strided_plain(
            keys_out, gy, feats, rq, rs, w, r_active, dkeys, kmap,
            window_r=window_r, q_bound=q_bound,
        )
    return _launch_bwd(keys_out, gy, feats, rq, rs, _bwd_weights(w), w.shape,
                       r_active, dkeys, kmap, window_r, q_bound)


window_bwd_strided.launches = 0


def _launch_bwd(keys_out, gy, feats, rq, rs, w_t, w_shape, r_active, dkeys,
                kmap, window_r, q_bound):
    """The backward kernels (csrc/window_bwd.cu) with the transposed weights
    ``w_t`` [K, CO, C] of ``w_shape`` [K, C, CO]; counts one launch of
    :func:`window_bwd_strided`."""
    dtype = _float_dtype(feats, "window_bwd_strided")
    b, nw1, m = rq.shape
    n_out, co = gy.shape[1], gy.shape[2]
    c = feats.shape[2]
    k, dk, cols = _offset_args(dkeys, kmap)
    _check(keys_out, "keys_out", torch.int32, 2)
    _check(gy, "gy", dtype, 3)
    _check(feats, "feats", dtype, 3)
    _check(rq, "rq", torch.int32, 3)
    _check(rs, "rs", torch.int32, 3)
    _check(w_t, "w_t", dtype, 3)
    _check(r_active, "r_active", torch.int32, 1)
    if (tuple(w_shape) != (k, c, co) or w_t.shape != (k, co, c)
            or keys_out.shape != (b, n_out) or feats.shape[:2] != (b, m)
            or gy.shape[0] != b):
        raise ValueError("window_bwd_strided: inconsistent shapes")
    if rs.shape[2] != k or rs.shape[1] < _cdiv(m, TILE_T):
        raise ValueError(f"rs {tuple(rs.shape)} does not fit M={m}, K={k}")
    dev = feats.device
    dx = torch.empty((b, m, c), dtype=dtype, device=dev)
    # the kernels write all of dw, but launch nothing without rows
    dw = (torch.zeros if b * m == 0 else torch.empty)(
        (k, c, co), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_parts = _bwd_dw_parts(sms, b, m, k, c, co)
    part = torch.empty((n_parts if n_parts > 1 else 0, k * c * co),
                       dtype=torch.float32, device=dev)
    name = "seid_window_bwd_bf16" if dtype == torch.bfloat16 else "seid_window_bwd_f32"
    fn = getattr(_native.lib("window_bwd"), name)
    err = fn(_ptr(keys_out), n_out, _ptr(gy), co, _ptr(feats), c, _ptr(rq),
             nw1 - 1, m, _ptr(rs), rs.shape[1], k, _ptr(w_t), _ptr(r_active),
             _query_rows_bound(m, q_bound), int(window_r), _ptr(dx), _ptr(dw),
             # dX is the conv of gy (CO channels) into dx (C): the conv's
             # cluster rule with the channels swapped
             dk, cols, b, _conv_groups(sms, b, m, k, co, c), _ptr(part),
             n_parts, _stream(feats))
    window_bwd_strided.launches += 1
    _native.check(err, "window_bwd_strided")
    return dx, dw


def window_bwd_subm(
    keys, feats, gy, qmeta, start, w, q_active, perm: Sequence[int],
    dkeys: Sequence[int], *, window_r: int, q_bound: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused submanifold backward on the FORWARD plan: output sites equal
    input sites, and the forward pair (i <- j, k) is the twin of
    (j <- i, perm[k]), so this is :func:`window_bwd_strided` with w[perm].
    -> (dx, dw_mirror); dW = (dw_mirror + twin sidecar)[perm]."""
    if not _use_kernel(keys, feats, gy, qmeta, start, w, q_active):
        perm_t = torch.as_tensor([int(p) for p in perm], device=w.device)
        return window_bwd_strided(
            keys, gy, feats, qmeta, start, w[perm_t].contiguous(), q_active,
            dkeys, window_r=window_r, q_bound=q_bound,
        )
    # the kernel needs only w[perm] transposed: one copy
    return _launch_bwd(keys, gy, feats, qmeta, start, _bwd_weights(w, perm),
                       w.shape, q_active, dkeys, None, window_r, q_bound)


# --------------------------------------------------------------------------
# window_dw
# --------------------------------------------------------------------------

def window_dw_plain(
    keys, feats, qmeta, start, gy, q_active, dkeys, kmap=None, *,
    window_r: int, q_bound: int | None = None,
) -> torch.Tensor:
    """Plain version of :func:`window_dw`: per offset, the matched table
    rows contracted with ``gy`` over batch and rows in float32."""
    window_dw_plain.calls += 1
    k, c, co = len(dkeys), feats.shape[-1], gy.shape[-1]
    gy32 = gy.float()
    dw = torch.zeros((k, c, co), dtype=torch.float32, device=feats.device)
    for kk, found, rows in _matched_rows(keys, qmeta, start, q_active, dkeys,
                                         kmap, window_r, q_bound):
        dw[kk] = torch.einsum(
            "bmc,bmo->co", _gather_matched(feats, found, rows), gy32
        )
    return dw


window_dw_plain.calls = 0


def _dw_parts(device, b: int, m: int, k: int, c: int, co: int) -> int:
    """Blocks that share out the query tiles in :func:`window_dw`, each
    summing its tiles into one row of partials: about four blocks an SM in
    all (the C == 1 route runs one block a part, the tiled route one a part
    and (offset, 32 channels, 32 outputs) piece of dw), and no more parts
    than tiles.  The count sets the kernel's summation order, so dw repeats
    bit for bit on one card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    pieces = 1 if c == 1 and co <= 32 else k * _cdiv(c, 32) * _cdiv(co, 32)
    return max(1, min(b * _cdiv(m, TILE_T), _cdiv(4 * sms, pieces)))


def window_dw(
    keys: torch.Tensor,  # i32[B, N_in] sorted keys of the table
    feats: torch.Tensor,  # [B, N_in, C] table features
    qmeta: torch.Tensor,  # i32[B, 1+nw, M]
    start: torch.Tensor,  # i32[B, n_tiles, K]
    gy: torch.Tensor,  # [B, M, CO] output cotangent, the feature type
    q_active: torch.Tensor,  # i32[B]
    dkeys: Sequence[int],
    kmap: Sequence[int] | None = None,
    *,
    window_r: int,
    q_bound: int | None = None,
) -> torch.Tensor:
    """-> dw float32 [K, C, CO] = sum over the in-window pairs of the plan
    of x[src] (outer) gy[dst].  ``window_r`` must be the plan's."""
    if not _use_kernel(keys, feats, qmeta, start, gy, q_active):
        return window_dw_plain(
            keys, feats, qmeta, start, gy, q_active, dkeys, kmap,
            window_r=window_r, q_bound=q_bound,
        )
    dtype = _float_dtype(feats, "window_dw")
    b, nw1, m = qmeta.shape
    n_in, c = feats.shape[1], feats.shape[2]
    co = gy.shape[2]
    k, dk, cols = _offset_args(dkeys, kmap)
    _check(keys, "keys", torch.int32, 2)
    _check(feats, "feats", dtype, 3)
    _check(qmeta, "qmeta", torch.int32, 3)
    _check(start, "start", torch.int32, 3)
    _check(gy, "gy", dtype, 3)
    _check(q_active, "q_active", torch.int32, 1)
    if keys.shape != (b, n_in) or gy.shape[:2] != (b, m) or feats.shape[0] != b:
        raise ValueError("window_dw: inconsistent shapes")
    if start.shape[2] != k or start.shape[1] < _cdiv(m, TILE_T):
        raise ValueError(f"start {tuple(start.shape)} does not fit M={m}, K={k}")
    dw = torch.zeros((k, c, co), dtype=torch.float32, device=feats.device)
    n_parts = _dw_parts(feats.device, b, m, k, c, co)
    part = torch.empty((n_parts, k * c * co), dtype=torch.float32,
                       device=feats.device)
    name = "seid_window_dw_bf16" if dtype == torch.bfloat16 else "seid_window_dw_f32"
    fn = getattr(_native.lib("window_dw"), name)
    err = fn(_ptr(keys), n_in, _ptr(feats), c, _ptr(qmeta), nw1 - 1, m,
             _ptr(start), start.shape[1], k, _ptr(gy), co, _ptr(q_active),
             _query_rows_bound(m, q_bound), int(window_r), _ptr(dw), dk, cols,
             b, _ptr(part), n_parts, _stream(feats))
    window_dw.launches += 1
    _native.check(err, "window_dw")
    return dw


window_dw.launches = 0


# --------------------------------------------------------------------------
# window_gather: the gathered neighbour matrix (first half of a two-step dW)
# --------------------------------------------------------------------------

def window_gather_plain(
    keys, feats, qmeta, start, q_active, dkeys, kmap=None, *, window_r: int,
) -> torch.Tensor:
    """Plain version of :func:`window_gather` (the same result, bit for
    bit): per kernel slot, the matched table rows, 0 where not found."""
    window_gather_plain.calls += 1
    b, _, m = qmeta.shape
    c = feats.shape[-1]
    g = torch.zeros((b, m, len(dkeys), c), dtype=feats.dtype,
                    device=feats.device)
    for kk, found, rows in _matched_rows(keys, qmeta, start, q_active, dkeys,
                                         kmap, window_r, None):
        g[:, :, kk] = _gather_matched(feats, found, rows).to(feats.dtype)
    return g.reshape(b, m, len(dkeys) * c)


window_gather_plain.calls = 0


def window_gather(
    keys: torch.Tensor,  # i32[B, N_in] sorted keys of the table
    feats: torch.Tensor,  # [B, N_in, C] table features
    qmeta: torch.Tensor,  # i32[B, 1+nw, M]
    start: torch.Tensor,  # i32[B, n_tiles, K]
    q_active: torch.Tensor,  # i32[B] live rows on the query side
    dkeys: Sequence[int],
    kmap: Sequence[int] | None = None,
    *,
    window_r: int,
) -> torch.Tensor:
    """-> g [B, M, K*C] in the feature type: g[b, m, kk*C:(kk+1)*C] is the
    table row that query (m, kmap[kk]) matches inside its plan window, else
    0; every row of a tile with no live query is 0.  The matched set is the
    one ``window_conv_apply`` counts.  ``window_r`` must be the plan's."""
    if not _use_kernel(keys, feats, qmeta, start, q_active):
        return window_gather_plain(
            keys, feats, qmeta, start, q_active, dkeys, kmap,
            window_r=window_r,
        )
    dtype = _float_dtype(feats, "window_gather")
    b, nw1, m = qmeta.shape
    n_in, c = feats.shape[1], feats.shape[2]
    k, dk, cols = _offset_args(dkeys, kmap)
    _check(keys, "keys", torch.int32, 2)
    _check(feats, "feats", dtype, 3)
    _check(qmeta, "qmeta", torch.int32, 3)
    _check(start, "start", torch.int32, 3)
    _check(q_active, "q_active", torch.int32, 1)
    if keys.shape != (b, n_in) or feats.shape[0] != b:
        raise ValueError("window_gather: inconsistent shapes")
    if start.shape[2] != k or start.shape[1] < _cdiv(m, TILE_T):
        raise ValueError(f"start {tuple(start.shape)} does not fit M={m}, K={k}")
    out = torch.empty((b, m, k * c), dtype=dtype, device=feats.device)
    name = ("seid_window_gather_bf16" if dtype == torch.bfloat16
            else "seid_window_gather_f32")
    fn = getattr(_native.lib("window_gather"), name)
    err = fn(_ptr(keys), n_in, _ptr(feats), c, _ptr(qmeta), nw1 - 1, m,
             _ptr(start), start.shape[1], k, _ptr(q_active), int(window_r),
             _ptr(out), dk, cols, b, _stream(feats))
    window_gather.launches += 1
    _native.check(err, "window_gather")
    return out


window_gather.launches = 0


# --------------------------------------------------------------------------
# overflow sidecar
# --------------------------------------------------------------------------

def _ov_bound(valid: torch.Tensor) -> torch.Tensor:
    """i32[B]: last valid index + 1 per batch element (0 if none).  Lists
    built on the device can hold invalid holes inside the prefix, so this
    is not a popcount; the kernels still check each entry."""
    s = valid.shape[1]
    idx = torch.arange(1, s + 1, device=valid.device, dtype=torch.int32)
    return (valid.to(torch.int32) * idx).amax(dim=1).to(torch.int32)


def overflow_dst_ordered(dst: torch.Tensor, n_bound: torch.Tensor) -> bool:
    """Whether ``dst`` is non-decreasing over every walked prefix (the
    entries below ``n_bound[b]``): the sidecar kernel's precondition."""
    idx = torch.arange(1, dst.shape[1], device=dst.device)
    inside = idx[None, :] < n_bound[:, None].long()
    return not bool((inside & (dst[:, 1:] < dst[:, :-1])).any())


def overflow_apply_plain(base, table, w, src, dst, kk, valid, n_bound=None):
    """Plain version of :func:`overflow_apply`, in place on ``base``.

    Entries are applied in list order with the output rounded after each,
    as the kernel does: entries are grouped into rounds that hold at most
    one entry per output row, and rounds run in order.  It takes any list;
    the kernel needs ``dst`` ordered (:func:`overflow_apply`)."""
    overflow_apply_plain.calls += 1
    b, m, co = base.shape
    s = src.shape[1]
    if n_bound is None:
        n_bound = _ov_bound(valid)
    idx = torch.arange(s, device=src.device)
    ok = valid & (idx[None, :] < n_bound[:, None])
    bi, si = torch.nonzero(ok, as_tuple=True)  # list order within each b
    if bi.numel() == 0:
        return base
    rows = table[bi, src[bi, si].long()].float()  # [E, C]
    contrib = torch.bmm(rows[:, None, :], w[kk[bi, si].long()].float())[:, 0]
    target = bi * m + dst[bi, si].long()
    order = torch.argsort(target, stable=True)
    ts = target[order]
    pos = torch.arange(ts.numel(), device=ts.device)
    first = torch.ones_like(ts, dtype=torch.bool)
    first[1:] = ts[1:] != ts[:-1]
    group_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - group_start
    flat = base.view(b * m, co)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        t = target[sel]
        flat[t] = (flat[t].float() + contrib[sel]).to(base.dtype)
    return base


overflow_apply_plain.calls = 0


def launch_overflow_kernel(base, table, w, src, dst, kk, valid, n_bound):
    """The sidecar kernel (csrc/overflow_apply.cu), in place on ``base``."""
    b, m, co = base.shape
    k, c, _ = w.shape
    n, s = table.shape[1], src.shape[1]
    dtype = _float_dtype(table, "overflow_apply")
    _check(base, "base", dtype, 3)
    _check(table, "table", dtype, 3)
    _check(w, "w", dtype, 3)
    for name, t in (("src", src), ("dst", dst), ("kk", kk), ("n_bound", n_bound)):
        _check(t, name, torch.int32)
    _check(valid, "valid", torch.bool, 2)
    if w.shape[1] != c or w.shape[2] != co or table.shape[0] != b:
        raise ValueError("overflow_apply: inconsistent shapes")
    name = (
        "seid_overflow_apply_bf16" if dtype == torch.bfloat16
        else "seid_overflow_apply_f32"
    )
    fn = getattr(_native.lib("overflow_apply"), name)
    err = fn(_ptr(base), m, co, _ptr(table), n, c, _ptr(w), k, _ptr(src),
             _ptr(dst), _ptr(kk), _ptr(valid), _ptr(n_bound), s, b,
             _stream(base))
    _native.check(err, "overflow_apply")
    return base


def overflow_apply(
    base: torch.Tensor,  # [B, M, CO] conv output, updated IN PLACE
    table: torch.Tensor,  # [B, N, C] table features
    w: torch.Tensor,  # [K, C, CO], the table's type
    src: torch.Tensor,  # i32[B, S]
    dst: torch.Tensor,  # i32[B, S]
    kk: torch.Tensor,  # i32[B, S]
    valid: torch.Tensor,  # bool[B, S]
    n_bound: torch.Tensor | None = None,  # i32[B]; default _ov_bound(valid)
) -> torch.Tensor:
    """base[b, dst] += W[kk]^T table[b, src] over the valid pairs, in list
    order.  Adds IN PLACE onto ``base`` and returns it.

    Precondition of the kernel: over each walked prefix (entries below
    ``n_bound[b]``, invalid holes included) ``dst`` is non-decreasing, so
    one output row's entries are contiguous.  Every list of the engine has
    it (``engine._compact_overflow`` keeps its entries in ascending flat
    position row * K + k); the kernel gives each row to one block and two
    blocks that shared a row would race on it."""
    if n_bound is None:
        n_bound = _ov_bound(valid)
    if not _use_kernel(base, table, w, src, dst, kk, valid, n_bound):
        return overflow_apply_plain(base, table, w, src, dst, kk, valid, n_bound)
    out = launch_overflow_kernel(base, table, w, src, dst, kk, valid, n_bound)
    overflow_apply.launches += 1
    return out


overflow_apply.launches = 0


# --------------------------------------------------------------------------
# overflow sidecar of the weight gradient
# --------------------------------------------------------------------------

def overflow_dw_plain(x, gy, k, src, dst, kk, valid, n_bound=None):
    """Plain version of :func:`overflow_dw`: the entries' outer products in
    float32, summed per offset."""
    overflow_dw_plain.calls += 1
    c, co = x.shape[-1], gy.shape[-1]
    if n_bound is None:
        n_bound = _ov_bound(valid)
    idx = torch.arange(src.shape[1], device=src.device)
    ok = valid & (idx[None, :] < n_bound[:, None])
    bi, si = torch.nonzero(ok, as_tuple=True)
    dw = torch.zeros((k, c, co), dtype=torch.float32, device=x.device)
    if bi.numel() == 0:
        return dw
    xs = x[bi, src[bi, si].long()].float()  # [E, C]
    gs = gy[bi, dst[bi, si].long()].float()  # [E, CO]
    return dw.index_add_(0, kk[bi, si].long(), xs[:, :, None] * gs[:, None, :])


overflow_dw_plain.calls = 0


_OV_PIECE = 4096  # floats of dw a block of the dW sidecar holds
_OV_SUM = 1 << 20  # most partial floats the dW sidecar's ordered sum reads


def _ov_dw_piece(k: int, c: int, co: int) -> Tuple[int, int]:
    """-> (offsets, input channels) of the dW sidecar's piece of dw: whole
    [C, CO] panels of as many offsets as fit ``_OV_PIECE`` floats (CO padded
    to a multiple of 4), else one offset and the channels cut about evenly
    in multiples of 8 (so a piece's rows start on 16 bytes)."""
    cop = _round_up(co, 4)
    if c * cop <= _OV_PIECE:
        return min(k, _OV_PIECE // (c * cop)), c
    cr = _round_up(_cdiv(c, _cdiv(c * cop, _OV_PIECE)), 8)
    while cr > 8 and cr * cop > _OV_PIECE:
        cr -= 8
    return 1, cr if cr * cop <= _OV_PIECE else max(1, _OV_PIECE // cop)


def _ov_dw_parts(sms: int, k: int, c: int, co: int) -> int:
    """Runs of the walked list entries the dW sidecar splits among its
    blocks (each writes its pieces' partials once): about two blocks an SM
    over all pieces, at most 256, and at most ``_OV_SUM`` partial floats for
    the ordered sum to read (4 MB; the scratch stays under
    ``_SCRATCH_BYTES``).  It depends on the shape only, never on the list,
    and fixes the summation order.  ``sweep_window_groups.py`` times the
    alternatives on the lists of both recipes' initial and level-0 convs."""
    kr, cr = _ov_dw_piece(k, c, co)
    pieces = _cdiv(k, kr) * _cdiv(c, cr)
    return max(1, min(256, _cdiv(2 * sms, pieces), _OV_SUM // (k * c * co)))


def launch_overflow_dw_kernel(x, gy, k, src, dst, kk, valid, n_bound):
    """The dW sidecar kernel (csrc/overflow_dw.cu) -> float32 [K, C, CO]."""
    dtype = _float_dtype(x, "overflow_dw")
    b, n, c = x.shape
    m, co = gy.shape[1], gy.shape[2]
    s = src.shape[1]
    _check(x, "x", dtype, 3)
    _check(gy, "gy", dtype, 3)
    for name, t in (("src", src), ("dst", dst), ("kk", kk), ("n_bound", n_bound)):
        _check(t, name, torch.int32)
    _check(valid, "valid", torch.bool, 2)
    if gy.shape[0] != b or src.shape[0] != b:
        raise ValueError("overflow_dw: inconsistent shapes")
    k = int(k)
    # the kernel writes all of dw, but launches nothing without events
    dw = (torch.zeros if b == 0 else torch.empty)(
        (k, c, co), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_parts = _ov_dw_parts(sms, k, c, co)
    kr, cr = _ov_dw_piece(k, c, co)
    part = torch.empty((n_parts if n_parts > 1 else 0, k * c * co),
                       dtype=torch.float32, device=x.device)
    name = "seid_overflow_dw_bf16" if dtype == torch.bfloat16 else "seid_overflow_dw_f32"
    fn = getattr(_native.lib("overflow_dw"), name)
    err = fn(_ptr(dw), k, _ptr(x), n, c, _ptr(gy), m, co, _ptr(src),
             _ptr(dst), _ptr(kk), _ptr(valid), _ptr(n_bound), s, b, _ptr(part),
             n_parts, kr, cr, _stream(x))
    _native.check(err, "overflow_dw")
    return dw


def overflow_dw(
    x: torch.Tensor,  # [B, N, C] table features
    gy: torch.Tensor,  # [B, M, CO] output cotangent, the table's type
    k: int,
    src: torch.Tensor,  # i32[B, S]
    dst: torch.Tensor,  # i32[B, S]
    kk: torch.Tensor,  # i32[B, S]
    valid: torch.Tensor,  # bool[B, S]
    n_bound: torch.Tensor | None = None,  # i32[B]; default _ov_bound(valid)
) -> torch.Tensor:
    """-> float32 [K, C, CO]: dw[kk] += x[src] (outer) gy[dst] over the
    valid pairs of every batch element."""
    if n_bound is None:
        n_bound = _ov_bound(valid)
    if not _use_kernel(x, gy, src, dst, kk, valid, n_bound):
        return overflow_dw_plain(x, gy, k, src, dst, kk, valid, n_bound)
    out = launch_overflow_dw_kernel(x, gy, k, src, dst, kk, valid, n_bound)
    overflow_dw.launches += 1
    return out


overflow_dw.launches = 0
