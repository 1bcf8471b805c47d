"""Sparse ResNet encoder (JAX counterpart: ``models/encoder.py``).

  initial 5^3 submanifold conv 1 -> n_initial_filters
  depth x [ BlockSeries(blocks_per_layer) ; strided 2^3 downsample ]
  final BlockSeries
  1x1 bottleneck -> n_output_filters, tanh (tanh(0) = 0 keeps padding inert)

Every level's plan is built on the device from its site set.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config.schema import ConvRepresentation, DownSampling, GrowthRate
from ..ops import SparseTensor
from ..ops.engine import apply_submanifold, build_series_plan, plan_overflow_dropped
from ..ops.window.query import WindowTuning
from .blocks import ConvolutionDownsample, SparseBlockSeries


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
    capacities over every plan (0 when the run is exact)."""

    def __init__(
        self,
        params: ConvRepresentation,
        dimension: int = 3,
        capacities: Tuple[int, ...] = (),
        backend: str = "xla",
        tuning: WindowTuning = WindowTuning(),
    ):
        super().__init__()
        if dimension != 3:
            raise NotImplementedError(
                "the 2D multiplane encoder is not ported yet (ROADMAP: the "
                "other models and tasks)"
            )
        if params.downsampling != DownSampling.convolutional:
            raise NotImplementedError(
                "pooling downsampling is not ported yet (ROADMAP: the other "
                "models and tasks)"
            )
        p = params
        self.params = p
        self.backend = backend
        self.tuning = tuning
        caps = tuple(capacities) or (None,) * (p.depth + 1)
        self.capacities = caps
        k3 = p.filter_size**3
        # one input channel: the voxel's charge
        self.initial_w = nn.Parameter(torch.empty(125, 1, p.n_initial_filters))
        self.initial_b = (
            nn.Parameter(torch.zeros(p.n_initial_filters)) if p.bias else None
        )
        filters = p.n_initial_filters
        for i in range(p.depth):
            self.add_module(
                f"series_{i}", SparseBlockSeries(p.blocks_per_layer, filters, p, k3)
            )
            if p.growth_rate == GrowthRate.multiplicative:
                nxt = filters * 2
            else:
                nxt = filters + p.n_initial_filters
            self.add_module(f"down_{i}", ConvolutionDownsample(
                filters, nxt, (2, 2, 2), p, out_capacity=caps[i + 1],
                backend=backend, q_bound_frac_in=self._qb_frac(i),
                q_bound_frac_out=self._qb_frac(i + 1), tuning=tuning,
            ))
            filters = nxt
        self.final_series = SparseBlockSeries(p.blocks_per_layer, filters, p, k3)
        self.bottleneck_w = nn.Parameter(torch.empty(1, filters, p.n_output_filters))
        self.bottleneck_b = (
            nn.Parameter(torch.zeros(p.n_output_filters)) if p.bias else None
        )

    def _qb_frac(self, level: int) -> float:
        p = self.params
        return min(1.0, p.query_bound_frac * p.query_bound_growth**level)

    def _plan(self, st: SparseTensor, ksize: int, level: int, window_r: int):
        return build_series_plan(
            st, (ksize,) * 3, backend=self.backend,
            q_bound_frac=self._qb_frac(level), window_r=window_r,
        )

    def forward(self, st: SparseTensor):
        p = self.params
        plan = self._plan(st, 5, 0, self.tuning.window_r_initial)
        dropped = plan_overflow_dropped(plan)
        st = apply_submanifold(st, plan, self.initial_w, self.initial_b)
        for i in range(p.depth):
            plan = self._plan(st, p.filter_size, i, self.tuning.for_level(i))
            dropped = dropped + plan_overflow_dropped(plan)
            st = getattr(self, f"series_{i}")(st, plan)
            st, d = getattr(self, f"down_{i}")(st)
            dropped = dropped + d
        plan = self._plan(st, p.filter_size, p.depth, self.tuning.for_level(p.depth))
        dropped = dropped + plan_overflow_dropped(plan)
        st = self.final_series(st, plan)
        # 1x1 bottleneck: pointwise, float32 like the flax einsum with f32
        # weights
        feats = torch.matmul(st.feats.float(), self.bottleneck_w[0].float())
        if self.bottleneck_b is not None:
            feats = feats + self.bottleneck_b
        feats = torch.where(st.row_mask()[..., None], feats, 0)
        return st.with_feats(torch.tanh(feats)), dropped
