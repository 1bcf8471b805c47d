"""Batched overflow sidecar entry point (JAX counterpart:
``sparseeventid_tpu/ops/pallas/window_sidecar.py:266``).

On the TPU the batched sidecar is its own one-hot GEMM kernel for C > 1,
while the serial walk serves C == 1.  On this card both entry points share
one kernel (``csrc/overflow_apply.cu``), which computes each chunk of
entries in parallel and applies them in list order; they keep separate
launch counts so a run shows which path it took.
"""

from __future__ import annotations

import torch

from .kernels import _use_kernel, launch_overflow_kernel, overflow_apply_plain


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
    PLACE onto ``base`` and returns it."""
    if not _use_kernel(base, table, w, src, dst, kk, valid, n_bound):
        return overflow_apply_plain(base, table, w, src, dst, kk, valid, n_bound)
    out = launch_overflow_kernel(base, table, w, src, dst, kk, valid, n_bound)
    overflow_apply_batched.launches += 1
    return out


overflow_apply_batched.launches = 0
