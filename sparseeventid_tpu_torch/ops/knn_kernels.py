"""The k nearest neighbours of every point of a point cloud as a CUDA kernel
(``csrc/knn.cu``), with its plain PyTorch version beside it.

``knn_topk`` dispatches as ``ops/window/kernels``' wrappers do: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, which raises on a
failed build or launch; there is no fallback.  The wrapper counts its calls
on the card in ``knn_topk.launches``, the plain version its calls in
``knn_topk_plain.calls``.  Neither is differentiable: the indices carry no
gradient, and the dynamic graph CNN calls them on detached features.

The rule both follow: squared euclidean distance in the input's type, a
padded candidate at 1e9, ascending by distance and among equal distances
by index (a stable sort, as ``jax.lax.top_k`` breaks ties); a cloud with
fewer than k valid points fills its rows with the lowest padded indices.
Both take the distance as ``(|x_i|^2 - 2 <x_i, x_j>) + |x_j|^2``, as the
JAX package does, but for clouds of at most ``DIRECT_FEATURES`` features,
where they sum the squared differences feature by feature: at the first
stage's raw coordinates (up to 1280) the expansion rounds |x|^2 to about
0.25, far above the charge's part of a neighbour's distance, and picks
among near-tied neighbours by its rounding.  On integer-valued inputs
small enough that every sum is exact in float32, kernel and plain version
give the same indices (on other inputs they round apart: the kernel fuses
each square into its sum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .window import _native
from .window.kernels import _check, _ptr, _stream, _use_kernel

MAX_K = 32  # csrc/knn.cu keeps at most 32 neighbours in registers
DIRECT_FEATURES = 16  # csrc/knn.cu kDirectFeatures


def knn_topk_plain(x: torch.Tensor, mask: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Plain version of :func:`knn_topk`: the whole distance matrix
    [..., P, P] and a stable sort of each row.  The JAX package's search,
    but for narrow clouds (see the module's rule)."""
    knn_topk_plain.calls += 1
    if x.shape[-1] <= DIRECT_FEATURES:
        d = sum((x[..., :, None, f] - x[..., None, :, f]) ** 2
                for f in range(x.shape[-1]))
    else:
        sq = (x * x).sum(dim=-1)
        d = (sq[..., :, None] - 2.0 * torch.einsum("...pf,...qf->...pq", x, x)
             + sq[..., None, :])
    d = torch.where(mask[..., None, :], d, 1e9)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


knn_topk_plain.calls = 0


def knn_topk(x: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """x [..., P, F], mask bool [..., P] -> int64 [..., P, k]: each point's
    k nearest valid points, itself included (see the module's rule).  On
    the card x is float32 and k at most 32."""
    if not _use_kernel(x, mask):
        return knn_topk_plain(x, mask, k)
    lead, (p, f) = x.shape[:-2], x.shape[-2:]
    if x.dtype != torch.float32:
        raise TypeError(f"knn_topk: dtype {x.dtype}, expected torch.float32")
    if mask.dtype != torch.bool or mask.shape != x.shape[:-1]:
        raise ValueError(f"knn_topk: mask {mask.dtype} {tuple(mask.shape)} "
                         f"for x {tuple(x.shape)}")
    if not 1 <= k <= min(p, MAX_K):
        raise ValueError(f"knn_topk: k={k} for P={p} (at most {MAX_K})")
    if f % 4:  # zero features change no distance
        x = F.pad(x, (0, 4 - f % 4))
    x = x.reshape(-1, p, x.shape[-1]).contiguous()
    m = mask.reshape(-1, p).contiguous().view(torch.uint8)
    _check(x, "x", torch.float32, 3)
    if x.data_ptr() % 16:
        raise ValueError("knn_topk: x is not 16-byte aligned")
    out = torch.empty((x.shape[0], p, k), dtype=torch.int64, device=x.device)
    err = _native.lib("knn").seid_knn_topk_f32(
        _ptr(x), _ptr(m), x.shape[0], p, x.shape[-1], k, _ptr(out),
        _stream(x))
    knn_topk.launches += 1
    _native.check(err, "knn_topk")
    return out.reshape(*lead, p, k)


knn_topk.launches = 0
