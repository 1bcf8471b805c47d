"""Host-built window plans -> the ``WindowPlan`` and ``SparseTensor``
objects the encoder consumes (JAX counterpart: ``ops/host_plans.py``).

The data-dependent part of a plan (the site pyramid's sort and unique, the
exact window starts, the out-of-window pairs) is built on the host by
``io.hostio.build_window_plans``, in the loader's thread.  Only the cheap
elementwise query meta is computed here on the device: it is [B, 1+nw, M]
a plan, too large to ship and quick to recompute.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from .engine import query_bound
from .rulebook import kernel_offsets
from .sparse_tensor import SparseTensor
from .window.engine import WindowPlan
from .window.query import (
    TILE_T,
    WindowTuning,
    _cdiv,
    compute_query_meta,
    compute_reverse_query_meta,
    compute_strided_query_meta,
    key_deltas,
)


@dataclasses.dataclass(frozen=True)
class EncoderPlans:
    """Every plan of one encoder pass, forward and backward."""

    initial: WindowPlan  # the 5^d plan on the level-0 site set
    series: Tuple[WindowPlan, ...]  # levels 0..depth
    down: Tuple[Tuple[WindowPlan, WindowPlan], ...]  # (forward, reverse) a level
    skeletons: Tuple[SparseTensor, ...]  # site sets of levels 1..depth
    site_dropped: torch.Tensor  # unique sites lost to the level capacities


def _plan_from_host(host, prefix, qmeta, dkeys, q_active, offsets, window_r,
                    q_bound) -> WindowPlan:
    return WindowPlan(
        qmeta, host[f"{prefix}/start"], q_active, host[f"{prefix}/ov_src"],
        host[f"{prefix}/ov_dst"], host[f"{prefix}/ov_k"],
        host[f"{prefix}/ov_valid"], host[f"{prefix}/ov_dropped"],
        offsets=tuple(map(tuple, offsets.tolist())), dkeys=tuple(dkeys),
        window_r=window_r, q_bound=q_bound,
    )


def encoder_plans_from_host(
    st0: SparseTensor,
    host: Dict[str, torch.Tensor],
    initial_kernel: Sequence[int],
    series_kernel,
    stride: Sequence[int],
    tuning: WindowTuning,
    q_bound_fracs: Sequence[float],
) -> EncoderPlans:
    """EncoderPlans from the host plan dict (on ``st0``'s device).

    ``st0`` is the level-0 SparseTensor of the batch the plans were built
    for: its rows are sorted by key as the host's are, so they agree row for
    row.  ``tuning`` must be the one the builder was given
    (``train/plans.plan_geometry`` derives both from the model): the
    kernels search windows of ``window_r`` rows at the host's starts.
    ``series_kernel`` is one kernel for every level or one a level (the 2D
    multiplane model's [1,k,k] -> [3,k,k] switch).  ``q_bound_fracs`` are
    the encoder's query bounds of levels 0..depth, each a fraction of its
    level's capacity (``models.encoder.Encoder.q_bound_fracs``)."""
    depth = len(q_bound_fracs) - 1
    host_tiles = host["lvl0/series/start"].shape[1]
    st_tiles = _cdiv(st0.capacity, TILE_T)
    if host_tiles != st_tiles:
        raise ValueError(
            f"host plans were built for {host_tiles} level-0 query tiles but "
            f"st0 has capacity {st0.capacity} ({st_tiles} tiles); build the "
            f"input SparseTensor with capacity={host_tiles * TILE_T} (the "
            "caps[0] given to build_window_plans)"
        )

    def q_bound(capacity, level):
        return query_bound(capacity, q_bound_fracs[level])

    i_offs = kernel_offsets(initial_kernel, centered=True)
    if hasattr(series_kernel[0], "__len__"):
        s_offs = [kernel_offsets(k, centered=True) for k in series_kernel]
    else:
        s_offs = [kernel_offsets(series_kernel, centered=True)] * (depth + 1)
    d_offs = kernel_offsets(stride, centered=False)
    kd = len(d_offs)

    levels = [st0]
    grid = st0.grid_shape
    for l in range(1, depth + 1):
        grid = tuple(-(-g // int(s)) for g, s in zip(grid, stride))
        coords = host[f"lvl{l}/coords"]
        levels.append(SparseTensor(
            coords=coords,
            feats=torch.zeros((*coords.shape[:2], 0), dtype=st0.feats.dtype,
                              device=coords.device),
            n_active=host[f"lvl{l}/n_active"],
            grid_shape=grid,
        ))

    initial = _plan_from_host(
        host, "initial", compute_query_meta(st0, i_offs),
        key_deltas(st0.grid_shape, i_offs), st0.n_active, i_offs,
        tuning.window_r_initial, q_bound(st0.capacity, 0),
    )
    series = tuple(
        _plan_from_host(
            host, f"lvl{l}/series", compute_query_meta(levels[l], s_offs[l]),
            key_deltas(levels[l].grid_shape, s_offs[l]), levels[l].n_active,
            s_offs[l], tuning.for_level(l), q_bound(levels[l].capacity, l),
        )
        for l in range(depth + 1)
    )
    down = tuple(
        (
            _plan_from_host(
                host, f"lvl{l}/down_f",
                compute_strided_query_meta(
                    levels[l + 1], levels[l].grid_shape, stride, d_offs),
                key_deltas(levels[l].grid_shape, d_offs),
                levels[l + 1].n_active, d_offs, tuning.window_r_strided,
                q_bound(levels[l + 1].capacity, l + 1),
            ),
            _plan_from_host(
                host, f"lvl{l}/down_r",
                compute_reverse_query_meta(levels[l], levels[l + 1], stride, kd),
                (0,) * kd, levels[l].n_active, d_offs, tuning.window_r,
                q_bound(levels[l].capacity, l),
            ),
        )
        for l in range(depth)
    )
    site_dropped = sum(
        (host[f"lvl{l}/site_dropped"].sum() for l in range(1, depth + 1)),
        torch.zeros((), dtype=torch.int64, device=st0.device),
    )
    return EncoderPlans(initial, series, down, tuple(levels[1:]), site_dropped)
