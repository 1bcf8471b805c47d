"""Gather-GEMM submanifold convolution over a rulebook (JAX counterpart:
``sparseeventid_tpu/ops/pallas/gather_conv.py``).

    out[b, m, :] = sum_k  feats[b, idx[b, m, k], :] @ W[k]     (miss -> 0)

``gather_conv`` is the kernel's wrapper (``csrc/gather_conv.cu``), with its
plain PyTorch version beside it: a CPU tensor goes to the plain version, a
CUDA tensor to the kernel, and a failed build or launch raises.  The
backward needs no scatter: the transpose of a submanifold rulebook is the
rulebook of the mirrored offsets, so dX is the same kernel on the output
cotangent with the index columns mirrored and the weights transposed, and
dW is one gather and one float32 product.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .rulebook import Rulebook
from .sparse_tensor import SparseTensor
from .window import _native
from .window.kernels import (
    _check, _conv_groups, _float_dtype, _ptr, _stream, _use_kernel,
)


def _gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """float32 [B, M, K, C]: feats[b, idx[b, m, k]], 0 at a miss."""
    b, m, k = idx.shape
    n, c = feats.shape[1], feats.shape[2]
    hit = (idx >= 0) & (idx < n)
    rows = torch.where(hit, idx, 0).long().reshape(b, m * k, 1)
    g = torch.gather(feats, 1, rows.expand(-1, -1, c)).reshape(b, m, k, c)
    return torch.where(hit[..., None], g.float(), 0.0)


def gather_conv_plain(feats, idx, w) -> torch.Tensor:
    """Plain version of :func:`gather_conv`: an index gather and one
    float32 contraction over (k, c), cast once to the feature type."""
    gather_conv_plain.calls += 1
    out = torch.einsum("bmkc,kco->bmo", _gather_rows(feats, idx), w.float())
    return out.to(feats.dtype)


gather_conv_plain.calls = 0


def gather_groups(sms: int, b: int, m: int, k: int, c: int, co: int) -> int:
    """Blocks (one thread-block cluster) that share a 128-row tile's
    offsets in the bf16 route of :func:`gather_conv`: the window conv's
    rule (``kernels._conv_groups``, whose tensor-core product and cluster
    sum the kernel shares) with at least 20 of the tile's 64-deep steps a
    block where the conv takes 13.  A gather block stages the tile's whole
    index block and every tile runs (the host cannot tell the live ones), so
    its fixed cost is larger; the limit is the best of 1, 2, 4 and 8 blocks
    at every dune3d level in ``sweep_window_groups.py --gather-conv`` on the
    H100 (PERF.md).  The fp32 route takes a tile in one block."""
    return _conv_groups(sms, b, m, k, c, co, min_steps=20)


def gather_conv(
    feats: torch.Tensor,  # [B, N, C] input features
    idx: torch.Tensor,  # i32[B, M, K] input row per (output row, offset)
    w: torch.Tensor,  # [K, C, CO], the feature type
) -> torch.Tensor:
    """-> [B, M, CO] in the feature type.  An index outside [0, N) is a
    miss (the rulebook encoding is ``N``) and contributes nothing."""
    if not _use_kernel(feats, idx, w):
        return gather_conv_plain(feats, idx, w)
    dtype = _float_dtype(feats, "gather_conv")
    b, n, c = feats.shape
    k, co = w.shape[0], w.shape[2]
    _check(feats, "feats", dtype, 3)
    _check(idx, "idx", torch.int32, 3)
    _check(w, "w", dtype, 3)
    if idx.shape[0] != b or idx.shape[2] != k or w.shape[1] != c:
        raise ValueError("gather_conv: inconsistent shapes")
    m = idx.shape[1]
    out = torch.empty((b, m, co), dtype=dtype, device=feats.device)
    name = ("seid_gather_conv_bf16" if dtype == torch.bfloat16
            else "seid_gather_conv_f32")
    fn = getattr(_native.lib("gather_conv"), name)
    sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
    err = fn(_ptr(feats), n, c, _ptr(idx), m, k, _ptr(w), co, _ptr(out), b,
             gather_groups(sms, b, m, k, c, co), _stream(feats))
    gather_conv.launches += 1
    _native.check(err, "gather_conv")
    return out


gather_conv.launches = 0


def gather_conv_single(feats: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """One event: feats [N, C], idx i32[M, K] (miss = N), w [K, C, CO] ->
    [M, CO].  The kernel takes the whole batch; this is its B = 1 call."""
    return gather_conv(feats[None], idx[None], w)[0]


def _encode_miss(rb: Rulebook, n: int) -> torch.Tensor:
    """Rulebook -> the miss-as-N index encoding the kernel takes."""
    return torch.where(rb.hit, rb.neighbor_idx, n).to(torch.int32)


def mirror_permutation(offsets: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    """Permutation p with offsets[p[k]] == -offsets[k]."""
    lookup = {tuple(o): i for i, o in enumerate(offsets)}
    return np.array(
        [lookup[tuple(-v for v in o)] for o in offsets], dtype=np.int64
    )


class _SubmGatherConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, idx_enc, w, offsets):
        ctx.save_for_backward(feats, idx_enc, w)
        ctx.offsets = offsets
        return gather_conv(feats, idx_enc, w)

    @staticmethod
    def backward(ctx, gy):
        feats, idx_enc, w = ctx.saved_tensors
        need_dx, _, need_dw, _ = ctx.needs_input_grad
        dx = dw = None
        if need_dx:
            # dX[j] = sum_d W[d]^T gy[nbr_{-d}(j)]: W[d]^T stays in column d
            # and pairs with the index column of -d.  Permuting both the
            # columns and the weights would cancel out.
            perm = torch.as_tensor(mirror_permutation(ctx.offsets),
                                   device=idx_enc.device)
            dx = gather_conv(
                gy.to(feats.dtype).contiguous(),
                idx_enc[:, :, perm].contiguous(),
                w.transpose(1, 2).contiguous(),
            )
        if need_dw:
            # dW[k] = sum_i x[nbr_k(i)] (outer) gy[i]
            dw = torch.einsum(
                "bnkc,bno->kco", _gather_rows(feats, idx_enc), gy.float()
            ).to(w.dtype)
        return dx, None, dw, None


def subm_gather_conv(
    feats: torch.Tensor,  # [B, N, C]
    idx_enc: torch.Tensor,  # i32[B, N, K], miss encoded as N
    w: torch.Tensor,  # [K, C, CO], the feature type
    offsets: Sequence[Sequence[int]],  # the rulebook's (centered) offsets
) -> torch.Tensor:
    """Batched submanifold conv on the gather kernel, differentiable in
    ``feats`` and ``w``.  Output sites == input sites."""
    return _SubmGatherConv.apply(
        feats, idx_enc, w, tuple(tuple(int(v) for v in o) for o in offsets)
    )


def gather_submanifold_conv(
    st: SparseTensor,
    rb: Rulebook,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """Drop-in for ``ops.conv.submanifold_conv`` on the gather kernel,
    forward and backward (the counterpart of the JAX package's
    ``pallas_submanifold_conv``).  As there, rows are masked only when a
    bias is added: without one a padding row's indices all miss."""
    idx_enc = _encode_miss(rb, st.capacity)
    out = subm_gather_conv(
        st.feats, idx_enc, w.to(st.feats.dtype).contiguous(), rb.offsets
    )
    if bias is not None:
        out = out + bias.to(out.dtype)
        out = torch.where(st.row_mask()[..., None], out, 0)
    return st.with_feats(out)
