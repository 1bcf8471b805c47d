"""Sparse network building blocks (JAX counterpart: ``models/blocks.py``).

Submodules and parameters carry the flax module names (``conv1``, ``norm``,
``w``, ``b``, ``block_0``, ...), so a flax parameter tree maps onto the
``state_dict`` by joining its path with dots (``convert.py``).  Plans are
explicit: a block series shares one plan for all its convs.

``checkpointed_series`` runs a series under ``torch.utils.checkpoint``
(flax's ``nn.remat``, ``framework.remat``): its activations are dropped
after the forward and recomputed in the backward.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.schema import ConvRepresentation, Norm
from ..ops import (
    SparseTensor,
    apply_norm,
    average_pool,
    masked_batch_stats,
    masked_group_norm,
)
from ..ops.engine import (
    WINDOW,
    XLA,
    apply_strided,
    apply_submanifold,
    apply_upsample,
    build_downsample_plan,
    build_upsample_plan,
    plan_overflow_dropped,
)
from ..ops.window.query import WindowTuning


class MaskedBatchNorm(nn.Module):
    """Batch norm over active voxels only (scn.BatchNormalization semantics:
    eps 1e-4, running averages with momentum 0.9).  Eval uses the running
    statistics.  With ``sync`` (JAX's ``axis_name``) training takes its
    statistics over the batches of every rank (sync batch norm); eval
    runs no collective.  ``update_stats`` is False only while a
    checkpointed series recomputes its forward: the running averages move
    once a step, as under flax's ``nn.remat``."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-4,
                 sync: bool = False):
        super().__init__()
        self.sync = sync
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.update_stats = True

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = masked_batch_stats(feats, mask, self.sync)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.mul_(m).add_((1.0 - m) * mean)
                    self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return apply_norm(feats, mask, mean, var, self.scale, self.bias, self.eps)


class MaskedGroupNorm(nn.Module):
    """scn.SparseGroupNorm: statistics per event and group over its live
    rows (eps 1e-5); no running statistics and no collective, so it is the
    same under data parallelism."""

    def __init__(self, channels: int, num_groups: int = 1, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return masked_group_norm(feats, mask, self.num_groups, self.scale,
                                 self.bias, self.eps)


def _make_norm(norm: Norm, channels: int, sync_bn: bool = False):
    if norm == Norm.batch:
        return MaskedBatchNorm(channels, sync=sync_bn)
    if norm in (Norm.group, Norm.layer):  # one group, as the reference
        return MaskedGroupNorm(channels)
    return None


class InputNorm(nn.Module):
    """SparseGroupNorm(1, C) on the raw input (the reference's InputNorm;
    the encoder does not call it)."""

    def __init__(self, channels: int = 1):
        super().__init__()
        self.norm = MaskedGroupNorm(channels)

    def forward(self, st: SparseTensor) -> SparseTensor:
        return st.with_feats(self.norm(st.feats, st.row_mask()))


def _leaky(st: SparseTensor, slope: float) -> SparseTensor:
    return st.with_feats(F.leaky_relu(st.feats, negative_slope=slope))


class SparseBlock(nn.Module):
    """Submanifold conv + norm + activation."""

    def __init__(self, c_in: int, n_out: int, params: ConvRepresentation,
                 k: int, activate: bool = True, sync_bn: bool = False):
        super().__init__()
        self.params = params
        self.activate = activate
        self.w = nn.Parameter(torch.empty(k, c_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out)) if params.bias else None
        self.norm = _make_norm(params.normalization, n_out, sync_bn)

    def forward(self, st: SparseTensor, plan) -> SparseTensor:
        out = apply_submanifold(st, plan, self.w, self.b)
        if self.norm is not None:
            out = out.with_feats(self.norm(out.feats, out.row_mask()))
        if self.activate:
            out = _leaky(out, self.params.leakiness)
        return out


class SparseResidualBlock(nn.Module):
    """conv-norm-act, conv-norm, + residual, act."""

    def __init__(self, channels: int, params: ConvRepresentation, k: int,
                 sync_bn: bool = False):
        super().__init__()
        self.params = params
        self.conv1 = SparseBlock(channels, channels, params, k, activate=True,
                                 sync_bn=sync_bn)
        self.conv2 = SparseBlock(channels, channels, params, k, activate=False,
                                 sync_bn=sync_bn)

    def forward(self, st: SparseTensor, plan) -> SparseTensor:
        out = self.conv2(self.conv1(st, plan), plan)
        return _leaky(out.with_feats(out.feats + st.feats), self.params.leakiness)


class SparseBlockSeries(nn.Module):
    """n_blocks (residual) blocks sharing one plan."""

    def __init__(self, n_blocks: int, channels: int,
                 params: ConvRepresentation, k: int, sync_bn: bool = False):
        super().__init__()
        self.names = [f"block_{i}" for i in range(n_blocks)]
        for name in self.names:
            block = (
                SparseResidualBlock(channels, params, k, sync_bn)
                if params.residual
                else SparseBlock(channels, channels, params, k, sync_bn=sync_bn)
            )
            self.add_module(name, block)

    def forward(self, st: SparseTensor, plan) -> SparseTensor:
        for name in self.names:
            st = getattr(self, name)(st, plan)
        return st


@contextlib.contextmanager
def _frozen_statistics(module: nn.Module, frozen: bool):
    norms = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.update_stats = not frozen
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def checkpointed_series(series: SparseBlockSeries, st: SparseTensor,
                        plan) -> SparseTensor:
    """``series(st, plan)`` under ``torch.utils.checkpoint``: the backward
    recomputes the forward instead of keeping its activations.  The
    recomputation normalises with the batch's statistics again but leaves
    the running averages alone (they move once, as flax's ``nn.remat``
    mutates ``batch_stats`` once).  Under sync batch norm it issues the
    all-reduce of each norm again; every rank recomputes the same series in
    the same order, so the collectives pair up, as JAX's remat reruns its
    ``psum``.  The plans are no tensors the checkpoint tracks: they pass
    through unchanged.  The series draws no random numbers, so no RNG state
    is kept."""
    calls = []

    def run(feats: torch.Tensor) -> torch.Tensor:
        calls.append(None)
        with _frozen_statistics(series, frozen=len(calls) > 1):
            return series(st.with_feats(feats), plan).feats

    feats = checkpoint(run, st.feats, use_reentrant=False,
                       preserve_rng_state=False)
    return st.with_feats(feats)


def offset_count(kernel: Tuple[int, ...]) -> int:
    """Offsets of a kernel (or of a stride's cell): the product of its sizes."""
    k = 1
    for s in kernel:
        k *= int(s)
    return k


def _downsample_plan(block, st: SparseTensor, precomputed):
    """(skeleton, plan, dropped) of a downsample block: the host-built
    (skeleton, (forward, reverse)) when given, whose lost sites the encoder
    counts once from the host's totals, else built on the device by the
    block's backend."""
    if precomputed is not None:
        skeleton, plan = precomputed
        return skeleton, plan, plan_overflow_dropped(plan)
    skeleton, plan, ds_dropped = build_downsample_plan(
        st, block.stride, block.out_capacity, backend=block.backend,
        q_bound_frac_in=block.q_bound_frac_in,
        q_bound_frac_out=block.q_bound_frac_out, tuning=block.tuning,
    )
    return skeleton, plan, ds_dropped.sum() + plan_overflow_dropped(plan)


class ConvolutionDownsample(nn.Module):
    """Strided conv (filter == stride, no bias) + norm + act.  Builds the
    coarser site set and its plans, or takes them from the host
    (``forward(st, (skeleton, plans))``); ``forward`` also returns the sites
    and pairs dropped by static capacities."""

    def __init__(
        self,
        c_in: int,
        n_out: int,
        stride: Tuple[int, ...],
        params: ConvRepresentation,
        out_capacity: int | None = None,
        backend: str = "xla",
        q_bound_frac_in: float = 1.0,
        q_bound_frac_out: float = 1.0,
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
    ):
        super().__init__()
        self.stride = tuple(stride)
        self.params = params
        self.out_capacity = out_capacity
        self.backend = backend
        self.q_bound_frac_in = q_bound_frac_in
        self.q_bound_frac_out = q_bound_frac_out
        self.tuning = tuning
        k = offset_count(self.stride)
        self.w = nn.Parameter(torch.empty(k, c_in, n_out))
        self.norm = _make_norm(params.normalization, n_out, sync_bn)

    def forward(self, st: SparseTensor, precomputed=None):
        skeleton, plan, dropped = _downsample_plan(self, st, precomputed)
        out = apply_strided(st, skeleton, plan, self.w)
        if self.norm is not None:
            out = out.with_feats(self.norm(out.feats, out.row_mask()))
        return _leaky(out, self.params.leakiness), dropped


class PoolingDownsample(nn.Module):
    """Average pooling + 1x1 filter update + norm + act, with the
    constructor and the ``forward`` of :class:`ConvolutionDownsample`.

    Average pooling divides by the FULL pool volume V, so pool + 1x1 conv
    is a strided conv whose weights are tied across the offsets:

        out[j] = (sum_k x[child_k(j)] / V) @ w  =  sum_k x[child_k(j)] @ (w / V)

    The window backend runs exactly that through ``apply_strided`` with
    W[k] = w / V for every k (the same plans and kernels as the
    convolutional downsample; the gradient to the shared ``w`` sums over k
    through the broadcast).  The plain backend pools over the rulebook and
    applies ``w`` in float32 and keeps the float32 product.  The float32
    bias is added as it is, so with bfloat16 features the block's output
    (and every later level) is float32 in both branches, as in the JAX
    package; without a bias the window branch keeps the feature type."""

    def __init__(
        self,
        c_in: int,
        n_out: int,
        stride: Tuple[int, ...],
        params: ConvRepresentation,
        out_capacity: int | None = None,
        backend: str = XLA,
        q_bound_frac_in: float = 1.0,
        q_bound_frac_out: float = 1.0,
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
    ):
        super().__init__()
        self.stride = tuple(stride)
        self.params = params
        self.out_capacity = out_capacity
        self.backend = backend
        self.q_bound_frac_in = q_bound_frac_in
        self.q_bound_frac_out = q_bound_frac_out
        self.tuning = tuning
        self.w = nn.Parameter(torch.empty(1, c_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out)) if params.bias else None
        self.norm = _make_norm(params.normalization, n_out, sync_bn)

    def forward(self, st: SparseTensor, precomputed=None):
        k = offset_count(self.stride)
        if precomputed is not None or self.backend == WINDOW:
            skeleton, plan, dropped = _downsample_plan(self, st, precomputed)
            wk = (self.w[0] / k).expand(k, -1, -1)
            feats = apply_strided(st, skeleton, plan, wk).feats
        else:
            skeleton, rb, ds_dropped = build_downsample_plan(
                st, self.stride, self.out_capacity, backend=XLA
            )
            dropped = ds_dropped.sum()
            pooled = average_pool(st, skeleton, rb, self.stride)
            feats = torch.matmul(pooled.feats.float(), self.w[0].float())
        if self.b is not None:
            feats = feats + self.b
        out = skeleton.with_feats(
            torch.where(skeleton.row_mask()[..., None], feats, 0)
        )
        if self.norm is not None:
            out = out.with_feats(self.norm(out.feats, out.row_mask()))
        return _leaky(out, self.params.leakiness), dropped


class ConvolutionUpsample(nn.Module):
    """Deconvolution (filter == stride) onto a supplied target site set +
    norm + act.  ``forward(st, target)`` also returns the pairs its plans
    dropped."""

    def __init__(
        self,
        c_in: int,
        n_out: int,
        stride: Tuple[int, ...],
        params: ConvRepresentation,
        backend: str = XLA,
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
    ):
        super().__init__()
        self.stride = tuple(stride)
        self.params = params
        self.backend = backend
        self.tuning = tuning
        self.w = nn.Parameter(torch.empty(offset_count(self.stride), c_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out)) if params.bias else None
        self.norm = _make_norm(params.normalization, n_out, sync_bn)

    def forward(self, st: SparseTensor, target: SparseTensor):
        plan = build_upsample_plan(
            st, target, self.stride, self.backend, tuning=self.tuning
        )
        dropped = plan_overflow_dropped(plan)
        out = apply_upsample(st, target, plan, self.w, self.b)
        if self.norm is not None:
            out = out.with_feats(self.norm(out.feats, out.row_mask()))
        return _leaky(out, self.params.leakiness), dropped
