"""Dynamic graph CNN classifier (JAX counterpart: ``models/dgcnn.py``) on
fixed-capacity point clouds [..., P, F] with a validity mask.

Each of four edge-conv stages (64, 64, 128, 256) builds the k-nearest
neighbour graph of its input features, forms the edge features
(x_j - x_i, x_i), applies a shared Dense, batch norm and leaky ReLU 0.2,
and takes the max over the neighbours (the tracer's spans: ``dgcnn.knn``
around the search, ``dgcnn.edge_conv`` around the rest of the stage, which
``ops/edge_conv_kernels.edge_conv`` runs without forming the edges: CUDA
kernels on the card, counted as ``edge_conv_fused`` while the tracer
records).  The stages' outputs are concatenated, mapped to ``emb_dims``,
and pooled by masked max and masked mean; multiplane clouds [B, planes,
P, F] share the weights and concatenate the planes' embeddings.  Then per label: FC
512, leaky ReLU, dropout, FC hidden, leaky ReLU, FC n.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from ..ops.edge_conv_kernels import edge_conv
from ..ops.knn_kernels import knn_topk
from ..utils import telemetry
from .dense import leaky_relu
from .heads import dropout
from .pointnet import Dense, MaskedPointBN, masked_max


def knn_indices(x: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[..., P, F] -> the indices [..., P, k] of each point's k nearest
    valid points, itself included, by squared euclidean distance in
    float32, or in the input's type where it is wider (bf16 and float16
    points, as ``run.precision=bfloat16`` gives the first stage, widen
    exactly).  Padded points sit at distance 1e9.  Equal distances take
    the lower index first, as ``jax.lax.top_k`` breaks ties (a stable
    sort; ``torch.topk`` promises no order among ties).  On the card the
    search is ``csrc/knn.cu``'s kernel, on the CPU the plain version
    (``ops/knn_kernels``); both run without autograd on the detached
    features, so no [..., P, P] tensor is kept for the backward."""
    x = x.detach()
    with torch.no_grad():
        return knn_topk(x.to(torch.promote_types(x.dtype, torch.float32)),
                        mask, k)


def edge_features(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(x_j - x_i, x_i) edge features [..., P, k, 2F], as the JAX package
    forms them (the model's stages never do: see ``EdgeConv``)."""
    p, f = x.shape[-2:]
    k = idx.shape[-1]
    flat = idx.reshape(*idx.shape[:-2], p * k, 1).expand(
        *idx.shape[:-2], p * k, f)
    gathered = torch.gather(x, -2, flat).reshape(*idx.shape, f)
    xi = x[..., :, None, :].expand_as(gathered)
    return torch.cat([gathered - xi, xi], dim=-1)


class EdgeConv(nn.Module):
    """One stage: the neighbour search, then ``edge_conv`` with the Dense's
    weight [n_out, 2 c_in] and the norm's parameters and running
    statistics (the JAX package's edge features, Dense, batch norm over
    the edges of the valid points, leaky ReLU 0.2 and max over the
    neighbours; 0 at the padded points)."""

    def __init__(self, c_in: int, n_out: int, k: int):
        super().__init__()
        self.k = k
        self.n_out = n_out
        self.fc = Dense(2 * c_in, n_out, bias=False)
        self.bn = MaskedPointBN(n_out)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with telemetry.span("dgcnn.knn"):
            idx = knn_indices(x, mask, self.k)
        with telemetry.span("dgcnn.edge_conv"):
            bn = self.bn
            return edge_conv(x, idx, mask, self.fc.weight, bn.scale, bn.bias,
                             bn.mean, bn.var, training=self.training,
                             momentum=bn.momentum, eps=bn.eps)


class DGCNNClassifier(nn.Module):
    """forward(pts, mask, generator=None) -> logits keyed by label; [B, P, F]
    or multiplane [B, planes, P, F] (``planes`` sizes the heads' input)."""

    def __init__(self, output_shape: Mapping[str, int], in_features: int = 4,
                 planes: int = 1, k: int = 20, emb_dims: int = 1024,
                 stage_dims: Sequence[int] = (64, 64, 128, 256),
                 head_hidden: int = 256, dropout: float = 0.5):
        super().__init__()
        self.p = dropout
        self.n_stages = len(stage_dims)
        c = in_features
        for i, f in enumerate(stage_dims):
            self.add_module(f"edge{i}", EdgeConv(c, f, k))
            c = f
        self.emb = Dense(sum(stage_dims), emb_dims, bias=False)
        self.emb_bn = MaskedPointBN(emb_dims)
        self.keys = list(output_shape)
        for key, n in output_shape.items():
            self.add_module(f"{key}_fc1", Dense(2 * emb_dims * planes, 512))
            self.add_module(f"{key}_fc2", Dense(512, head_hidden))
            self.add_module(f"{key}_out", Dense(head_hidden, n))

    def forward(self, pts: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        x = pts
        stages = []
        for i in range(self.n_stages):
            x = getattr(self, f"edge{i}")(x, mask)
            stages.append(x)
        h = leaky_relu(self.emb_bn(self.emb(torch.cat(stages, dim=-1)), mask),
                       0.2)
        m = mask[..., None].to(h.dtype)
        gavg = (h * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)
        emb = torch.cat([masked_max(h, mask, axis=-2), gavg], dim=-1)
        if pts.ndim == 4:
            emb = emb.reshape(emb.shape[0], -1)
        out = {}
        for key in self.keys:
            h2 = leaky_relu(getattr(self, f"{key}_fc1")(emb), 0.2)
            h2 = dropout(h2, self.p, self.training, generator)
            h2 = leaky_relu(getattr(self, f"{key}_fc2")(h2), 0.2)
            out[key] = getattr(self, f"{key}_out")(h2)
        return out
