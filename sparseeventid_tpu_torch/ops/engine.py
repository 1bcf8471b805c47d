"""Backend dispatch of the sparse conv engine.

Two interchangeable backends, as in the JAX package:
  * 'xla'    - searchsorted rulebooks + gathers (ops/conv.py): the exact
               plain reference, runs anywhere;
  * 'window' - sorted-window plans and the CUDA kernels (ops/window/): the
               main path on the card; plain versions of the kernels on CPU.

Models call these functions with a plan whose type selects the backend.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .conv import deconv, strided_conv, submanifold_conv
from .rulebook import (
    build_downsample_rulebook,
    build_submanifold_rulebook,
    build_upsample,
    downsample_sites,
)
from .sparse_tensor import SparseTensor
from .window.engine import (
    WindowPlan,
    build_strided_window_plans,
    build_submanifold_window_plan,
    window_deconv,
    window_strided_conv,
    window_submanifold_conv,
)
from .window.query import TILE_T, WindowTuning

XLA = "xla"
WINDOW = "window"

# Query-row bounds are whole multiples of this (four 128-query tiles, the
# GRID_QUANTUM of the level capacities).
QUERY_STEP = 4 * TILE_T


def query_bound(capacity: int, frac: float | None) -> int | None:
    """Static query-row bound of the window kernels: a fraction of the
    level capacity rounded up to QUERY_STEP; None keeps the capacity."""
    if frac is None or frac >= 1.0:
        return None
    b = max(int(capacity * frac), QUERY_STEP)
    b = ((b + QUERY_STEP - 1) // QUERY_STEP) * QUERY_STEP
    return None if b >= capacity else b


def device_list_width(capacity: int) -> int:
    """Width of an overflow list built on the device (``ops.window.engine``):
    the level capacity (at least 256).

    A device-built list also holds the unmatched candidates of query tiles
    whose anchor block escaped the plan window; at dune3d occupancy those
    outnumber the real pairs 2-3x on the downsample plans and pass the host
    widths (:func:`host_list_width`) on the level-0 downsample and the
    initial 5^3 plan.  The width costs no kernel time (the sidecar walks
    only to the last valid entry), so the list is as wide as the level."""
    return max(256, capacity)


def host_list_width(capacity: int, k: int = 27) -> int:
    """Width of an overflow list built on the host
    (``io.hostio.build_window_plans``), whose lists hold only real
    out-of-window pairs: capacity // 6 for up to 27 offsets, scaled by
    ceil(k / 27) (a 5^3 kernel spills about 5x the pairs of a 3^3 one),
    within [256, 16384].  The JAX package's ``_overflow_cap``, unchanged:
    ``chip_smoke.py``'s ``host_plans`` phase prints each plan's largest
    per-event pair count against it at both recipes."""
    scale = max(1, -(-k // 27))
    return max(256, min(16384, (capacity // 6) * scale))


def build_series_plan(
    st: SparseTensor, kernel_size, backend: str = XLA,
    q_bound_frac: float = 1.0, window_r: int | None = None,
):
    if backend == WINDOW:
        return build_submanifold_window_plan(
            st, kernel_size,
            window_r=WindowTuning().window_r if window_r is None else window_r,
            overflow_cap=device_list_width(st.capacity),
            q_bound=query_bound(st.capacity, q_bound_frac),
        )
    return build_submanifold_rulebook(st, kernel_size)


def apply_submanifold(st: SparseTensor, plan, w, bias=None) -> SparseTensor:
    if isinstance(plan, WindowPlan):
        return window_submanifold_conv(st, plan, w, bias)
    return submanifold_conv(st, plan, w, bias)


def build_downsample_plan(
    st: SparseTensor,
    stride: Sequence[int],
    out_capacity: int | None = None,
    backend: str = XLA,
    q_bound_frac_in: float = 1.0,
    q_bound_frac_out: float = 1.0,
    tuning: WindowTuning = WindowTuning(),
):
    """-> (skeleton, plan, dropped): ``dropped`` counts the unique output
    sites lost to the static capacity per event."""
    skeleton, dropped = downsample_sites(
        st, stride, out_capacity, with_dropped=True
    )
    if backend == WINDOW:
        plans = build_strided_window_plans(
            st, skeleton, stride,
            overflow_cap=device_list_width(st.capacity),
            q_bound=query_bound(skeleton.capacity, q_bound_frac_out),
            rev_q_bound=query_bound(st.capacity, q_bound_frac_in),
            tuning=tuning,
        )
        return skeleton, plans, dropped
    return skeleton, build_downsample_rulebook(st, skeleton, stride), dropped


def apply_strided(st: SparseTensor, skeleton: SparseTensor, plan, w):
    if isinstance(plan, tuple) and isinstance(plan[0], WindowPlan):
        fwd, rev = plan
        return window_strided_conv(st, skeleton, fwd, rev, w)
    return strided_conv(st, skeleton, plan, w)


def build_upsample_plan(
    st_coarse: SparseTensor,
    target: SparseTensor,
    stride: Sequence[int],
    backend: str = XLA,
    tuning: WindowTuning = WindowTuning(),
):
    """Plan of a deconvolution onto a supplied finer site set.  The window
    backend builds the strided conv's (forward, reverse) plans with the FINE
    set in the input role (``window.engine.window_deconv``)."""
    if backend == WINDOW:
        return build_strided_window_plans(
            target, st_coarse, stride,
            overflow_cap=device_list_width(target.capacity), tuning=tuning,
        )
    return build_upsample(st_coarse, target, stride)


def apply_upsample(
    st_coarse: SparseTensor, target: SparseTensor, plan, w, bias=None
) -> SparseTensor:
    if isinstance(plan, tuple) and plan and isinstance(plan[0], WindowPlan):
        fwd, rev = plan
        out = window_deconv(st_coarse, target, fwd, rev, w)
        if bias is not None:
            out = out.with_feats(torch.where(
                out.row_mask()[..., None],
                out.feats + bias.to(out.feats.dtype), 0,
            ))
        return out
    return deconv(st_coarse, target, plan, w, bias)


def plan_overflow_dropped(plan) -> torch.Tensor:
    """Conv pairs lost to the overflow list's static capacity, plus any live
    rows past a query bound (0 for rulebooks, which are exact)."""

    def one(p: WindowPlan):
        tot = p.ov_dropped.sum()
        if p.q_bound is not None:
            tot = tot + torch.clamp(p.q_active - p.q_bound, min=0).sum()
        return tot

    if isinstance(plan, WindowPlan):
        return one(plan)
    if isinstance(plan, tuple) and plan and isinstance(plan[0], WindowPlan):
        return sum(one(p) for p in plan)
    return torch.zeros((), dtype=torch.int64)
