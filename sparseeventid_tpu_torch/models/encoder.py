"""Sparse ResNet encoder (JAX counterpart: ``models/encoder.py``).

  initial 5^d submanifold conv 1 -> n_initial_filters
  depth x [ BlockSeries(blocks_per_layer) ; stride-2 downsample ]
  final BlockSeries
  1x1 bottleneck -> n_output_filters, tanh (tanh(0) = 0 keeps padding inert)

2D multiplane data is a 3D grid with the plane index as coordinate 0:
kernels are [1, k, k] (weights shared by the planes, no mixing across
them) and the stride is (1, 2, 2); from ``plane_merge_depth`` on (if >= 0)
the kernels are [3, k, k] and do mix planes.

``forward(st, plans)`` takes every plan and site set from an
``ops.host_plans.EncoderPlans`` built on the host (the main path: the
trainer's loader builds them); without ``plans`` each level's plan is built
on the device from its site set.

With ``remat`` (``framework.remat``, JAX's ``nn.remat`` of each block
series) a training forward runs every block series under
``torch.utils.checkpoint``: the backward recomputes the series' forward
instead of keeping its activations.  The gradients are the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config.schema import ConvRepresentation, DownSampling, GrowthRate
from ..ops import SparseTensor
from ..ops.engine import apply_submanifold, build_series_plan, plan_overflow_dropped
from ..ops.window.query import WindowTuning
from .blocks import (
    ConvolutionDownsample,
    PoolingDownsample,
    SparseBlockSeries,
    checkpointed_series,
    offset_count,
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Level capacities are multiples of four 128-query tiles, so every
# [B, cap, *] tensor lands exactly on whole kernel tiles.
GRID_QUANTUM = 512


def capacity_schedule(
    n0: int, depth: int, shrink: float, min_capacity: int
) -> Tuple[int, ...]:
    """Static per-level COO capacities: each downsample keeps
    max(min_capacity, shrink * previous), GRID_QUANTUM-aligned and never
    growing."""
    caps = [_round_up(n0, GRID_QUANTUM)]
    c = n0
    for _ in range(depth):
        c = max(min_capacity, int(c * shrink))
        caps.append(min(_round_up(c, GRID_QUANTUM), caps[-1]))
    return tuple(caps)


class Encoder(nn.Module):
    """forward(st) -> (encoded SparseTensor with tanh applied, dropped),
    where ``dropped`` sums the sites and conv pairs lost to static
    capacities over every plan (0 when the run is exact).  ``sync_bn``
    makes every batch norm a sync batch norm (JAX's ``axis_name``);
    ``remat`` recomputes each block series in the backward."""

    def __init__(
        self,
        params: ConvRepresentation,
        dimension: int = 3,
        capacities: Tuple[int, ...] = (),
        backend: str = "xla",
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if dimension not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {dimension}")
        p = params
        self.params = p
        self.dimension = dimension
        self.backend = backend
        self.tuning = tuning
        self.remat = remat
        caps = tuple(capacities) or (None,) * (p.depth + 1)
        self.capacities = caps
        downsampler = (
            ConvolutionDownsample
            if p.downsampling == DownSampling.convolutional
            else PoolingDownsample
        )
        # one input channel: the voxel's charge
        self.initial_w = nn.Parameter(
            torch.empty(offset_count(self._kernel(5, 0)), 1, p.n_initial_filters)
        )
        self.initial_b = (
            nn.Parameter(torch.zeros(p.n_initial_filters)) if p.bias else None
        )
        filters = p.n_initial_filters
        for i in range(p.depth):
            self.add_module(f"series_{i}", SparseBlockSeries(
                p.blocks_per_layer, filters, p,
                offset_count(self._kernel(p.filter_size, i)), sync_bn,
            ))
            if p.growth_rate == GrowthRate.multiplicative:
                nxt = filters * 2
            else:
                nxt = filters + p.n_initial_filters
            self.add_module(f"down_{i}", downsampler(
                filters, nxt, self._stride(), p, out_capacity=caps[i + 1],
                backend=backend, q_bound_frac_in=self._qb_frac(i),
                q_bound_frac_out=self._qb_frac(i + 1), tuning=tuning,
                sync_bn=sync_bn,
            ))
            filters = nxt
        self.final_series = SparseBlockSeries(
            p.blocks_per_layer, filters, p,
            offset_count(self._kernel(p.filter_size, p.depth)), sync_bn,
        )
        self.bottleneck_w = nn.Parameter(torch.empty(1, filters, p.n_output_filters))
        self.bottleneck_b = (
            nn.Parameter(torch.zeros(p.n_output_filters)) if p.bias else None
        )

    def _kernel(self, k: int, level: int) -> Tuple[int, ...]:
        if self.dimension == 2:
            pm = self.params.plane_merge_depth
            if pm >= 0 and level >= pm:
                return (3, k, k)
            return (1, k, k)
        return (k,) * 3

    def _stride(self) -> Tuple[int, ...]:
        return (1, 2, 2) if self.dimension == 2 else (2, 2, 2)

    def plan_kernels(self):
        """(initial kernel, series kernel of each level 0..depth, stride):
        the geometry a host plan builder must be given for this encoder."""
        p = self.params
        return (
            self._kernel(5, 0),
            tuple(self._kernel(p.filter_size, l) for l in range(p.depth + 1)),
            self._stride(),
        )

    def _qb_frac(self, level: int) -> float:
        p = self.params
        return min(1.0, p.query_bound_frac * p.query_bound_growth**level)

    def _plan(self, st: SparseTensor, ksize: int, level: int, window_r: int):
        return build_series_plan(
            st, self._kernel(ksize, level), backend=self.backend,
            q_bound_frac=self._qb_frac(level), window_r=window_r,
        )

    def _series(self, series: SparseBlockSeries, st: SparseTensor, plan):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpointed_series(series, st, plan)
        return series(st, plan)

    def forward(self, st: SparseTensor, plans=None):
        p = self.params
        if plans is None:
            plan = self._plan(st, 5, 0, self.tuning.window_r_initial)
            dropped = plan_overflow_dropped(plan)
        else:
            plan = plans.initial
            dropped = plans.site_dropped + plan_overflow_dropped(plan)
        st = apply_submanifold(st, plan, self.initial_w, self.initial_b)
        for i in range(p.depth):
            if plans is None:
                plan = self._plan(st, p.filter_size, i, self.tuning.for_level(i))
            else:
                plan = plans.series[i]
            dropped = dropped + plan_overflow_dropped(plan)
            st = self._series(getattr(self, f"series_{i}"), st, plan)
            precomputed = (
                None if plans is None else (plans.skeletons[i], plans.down[i])
            )
            st, d = getattr(self, f"down_{i}")(st, precomputed)
            dropped = dropped + d
        if plans is None:
            plan = self._plan(st, p.filter_size, p.depth,
                              self.tuning.for_level(p.depth))
        else:
            plan = plans.series[p.depth]
        dropped = dropped + plan_overflow_dropped(plan)
        st = self._series(self.final_series, st, plan)
        # 1x1 bottleneck: pointwise, float32 like the flax einsum with f32
        # weights
        feats = torch.matmul(st.feats.float(), self.bottleneck_w[0].float())
        if self.bottleneck_b is not None:
            feats = feats + self.bottleneck_b
        feats = torch.where(st.row_mask()[..., None], feats, 0)
        return st.with_feats(torch.tanh(feats)), dropped


def encoder_output_shape(
    cfg_encoder: ConvRepresentation, image_shape: Tuple[int, ...],
    dimension: int,
) -> Tuple[int, ...]:
    """[C, *spatial / 2**depth]; the plane axis of 2D data is not strided."""
    scale = 2**cfg_encoder.depth
    if dimension == 2:
        spatial = [image_shape[0]] + [s // scale for s in image_shape[1:]]
    else:
        spatial = [s // scale for s in image_shape]
    return tuple([cfg_encoder.n_output_filters] + spatial)
