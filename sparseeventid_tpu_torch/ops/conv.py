"""Sparse convolution by gather + one dense GEMM over a rulebook: the exact
plain backend (the JAX package names it ``xla``).

    out[b, n, :] = sum_k  W[k]^T feats[b, nbr[b, n, k], :]   (miss -> 0)

One gather to [B, N, K*C], one matmul with W.reshape(K*C, CO), accumulated
in float32 and cast once to the feature type.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .rulebook import Rulebook
from .sparse_tensor import SparseTensor


def gather_neighbors(feats: torch.Tensor, rb: Rulebook) -> torch.Tensor:
    """feats [B, N_in, C], rulebook [B, N_out, K] -> [B, N_out, K, C]."""
    b, n_out, k = rb.neighbor_idx.shape
    c = feats.shape[-1]
    idx = rb.neighbor_idx.long().reshape(b, n_out * k, 1).expand(-1, -1, c)
    g = torch.gather(feats, 1, idx).reshape(b, n_out, k, c)
    return torch.where(rb.hit[..., None], g, 0)


def apply_conv(
    feats: torch.Tensor,  # [B, N_in, C]
    rb: Rulebook,
    w: torch.Tensor,  # [K, C, CO]
    bias: torch.Tensor | None = None,  # [CO]
    out_mask: torch.Tensor | None = None,  # bool[B, N_out]
) -> torch.Tensor:
    """Core gather-GEMM -> [B, N_out, CO]."""
    b, n_out, k = rb.neighbor_idx.shape
    c = feats.shape[-1]
    g = gather_neighbors(feats, rb).reshape(b, n_out, k * c)
    w2 = w.to(feats.dtype).reshape(k * c, w.shape[-1])
    out = torch.matmul(g.float(), w2.float()).to(feats.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if out_mask is not None:
        out = torch.where(out_mask[..., None], out, 0)
    return out


def submanifold_conv(
    st: SparseTensor, rb: Rulebook, w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """scn.SubmanifoldConvolution: output sites == input sites."""
    return st.with_feats(apply_conv(st.feats, rb, w, bias, st.row_mask()))


def strided_conv(
    st_in: SparseTensor,
    skeleton: SparseTensor,
    rb: Rulebook,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """scn.Convolution with filter_size == filter_stride (downsample)."""
    out = apply_conv(st_in.feats, rb, w, bias, skeleton.row_mask())
    return skeleton.with_feats(out)


def deconv(
    st_coarse: SparseTensor,
    target: SparseTensor,
    rb: Rulebook,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> SparseTensor:
    """scn.Deconvolution onto a supplied finer site set (``rb`` from
    ``rulebook.build_upsample``)."""
    out = apply_conv(st_coarse.feats, rb, w, bias, target.row_mask())
    return target.with_feats(out)


def average_pool(
    st_in: SparseTensor,
    skeleton: SparseTensor,
    rb: Rulebook,
    pool_size: Sequence[int],
) -> SparseTensor:
    """scn.AveragePooling: the sum of the child features divided by the FULL
    pool volume (not by the count of live children)."""
    g = gather_neighbors(st_in.feats, rb)  # [B, N_out, K, C]
    vol = 1
    for p in pool_size:
        vol *= int(p)
    out = g.sum(dim=2) / torch.tensor(vol, dtype=g.dtype, device=g.device)
    out = torch.where(skeleton.row_mask()[..., None], out, 0)
    return skeleton.with_feats(out)
