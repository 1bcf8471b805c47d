"""Batched overflow sidecar entry points (JAX counterparts:
``sparseeventid_tpu/ops/pallas/window_sidecar.py:266`` and ``:377``).

On the TPU the batched sidecars are their own one-hot GEMM kernels for
C > 1, while the serial walks serve C == 1.  On this card the two entry
points of each sidecar share one kernel (``csrc/overflow_apply.cu``, which
spreads each event's list over blocks aligned to output rows and applies a
row's entries in list order; ``csrc/overflow_dw.cu``, which splits the
walked entries into a fixed number of runs and sums each element of dw
over them in list order, then over the runs in order); they keep separate
launch counts so a run shows which path it took.
"""

from __future__ import annotations

import torch

from .kernels import (
    _use_kernel,
    launch_overflow_dw_kernel,
    launch_overflow_kernel,
    overflow_apply_plain,
    overflow_dw_plain,
)


def overflow_apply_batched(
    base: torch.Tensor,  # [B, M, CO] conv output, updated IN PLACE
    table: torch.Tensor,  # [B, N, C]
    w: torch.Tensor,  # [K, C, CO], the table's type
    src: torch.Tensor,  # i32[B, S]
    dst: torch.Tensor,  # i32[B, S]
    kk: torch.Tensor,  # i32[B, S]
    valid: torch.Tensor,  # bool[B, S]
    n_bound: torch.Tensor,  # i32[B] entries to walk (last valid + 1)
) -> torch.Tensor:
    """base[b, dst] += W[kk]^T table[b, src] over the valid pairs.  Adds IN
    PLACE onto ``base`` and returns it.  ``dst`` must be non-decreasing over
    each walked prefix, as for :func:`kernels.overflow_apply`."""
    if not _use_kernel(base, table, w, src, dst, kk, valid, n_bound):
        return overflow_apply_plain(base, table, w, src, dst, kk, valid, n_bound)
    out = launch_overflow_kernel(base, table, w, src, dst, kk, valid, n_bound)
    overflow_apply_batched.launches += 1
    return out


overflow_apply_batched.launches = 0


def overflow_dw_batched(
    x: torch.Tensor,  # [B, N, C] table features
    gy: torch.Tensor,  # [B, M, CO] output cotangent, the table's type
    k: int,
    src: torch.Tensor,  # i32[B, S]
    dst: torch.Tensor,  # i32[B, S]
    kk: torch.Tensor,  # i32[B, S]
    valid: torch.Tensor,  # bool[B, S]
    n_bound: torch.Tensor,  # i32[B] entries to walk (last valid + 1)
) -> torch.Tensor:
    """-> float32 [K, C, CO]: dw[kk] += x[src] (outer) gy[dst] over the
    valid pairs of every batch element."""
    if not _use_kernel(x, gy, src, dst, kk, valid, n_bound):
        return overflow_dw_plain(x, gy, k, src, dst, kk, valid, n_bound)
    out = launch_overflow_dw_kernel(x, gy, k, src, dst, kk, valid, n_bound)
    overflow_dw_batched.launches += 1
    return out


overflow_dw_batched.launches = 0
