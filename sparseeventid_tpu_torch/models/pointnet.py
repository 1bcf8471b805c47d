"""PointNet classifier (JAX counterpart: ``models/pointnet.py``) on
fixed-capacity point clouds [..., P, F] with a validity mask.

  TNet(F) input transform -> MLP(64, 64) -> TNet(64) feature transform
  -> MLP(64, 128, 1024) -> max over the valid points
  -> (multiplane [B, planes, P, F]: the planes' embeddings concatenated)
  -> per label: FC 512 -> dropout -> FC hidden -> FC n

Padded points take no part in a max (they sit at -1e9) or in a norm's
statistics.  A TNet maps its input through a k x k matrix that starts as
the identity (its ``fc3`` is zero-initialised) and reports the
orthogonality penalty ||I - A A^T||^2.  The layers follow flax's type
rules: a bfloat16 input meets float32 weights in float32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .heads import dropout


class Dense(nn.Linear):
    """flax ``nn.Dense``: the input is promoted to the float32 weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class MaskedPointBN(nn.Module):
    """Batch norm over the valid points of the whole batch (momentum 0.9,
    eps 1e-5); eval mode uses the running statistics."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].float()
            cnt = torch.clamp(m.sum(), min=1.0)
            xf = x.float()
            dims = tuple(range(x.ndim - 1))
            mean = (xf * m).sum(dims) / cnt
            var = torch.clamp((xf * xf * m).sum(dims) / cnt - mean**2, min=0.0)
            with torch.no_grad():
                mm = self.momentum
                self.mean.mul_(mm).add_((1 - mm) * mean)
                self.var.mul_(mm).add_((1 - mm) * var)
        else:
            mean, var = self.mean, self.var
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return torch.where(mask[..., None], out, 0).to(x.dtype)


class PointMLP(nn.Module):
    """Shared per-point MLP: (Dense, MaskedPointBN, ReLU) per width."""

    def __init__(self, c_in: int, features: Sequence[int]):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"fc{i}", Dense(c_in, f))
            self.add_module(f"bn{i}", MaskedPointBN(f))
            c_in = f

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), mask))
        return torch.where(mask[..., None], x, 0)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int) -> torch.Tensor:
    """Max over ``axis`` with the masked rows at -1e9."""
    return torch.where(mask[..., None], x, -1e9).amax(dim=axis)


class TNet(nn.Module):
    """Spatial / feature transform: forward(x, mask) -> (x A, penalty)."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.mlp = PointMLP(k, (64, 128, 1024))
        self.fc1 = Dense(1024, 512)
        self.fc2 = Dense(512, 256)
        self.fc3 = Dense(256, k * k)
        self.fc3.zero_init = True  # the transform starts as the identity

    def forward(self, x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.mlp(x, mask)
        pooled = masked_max(h, mask, axis=-2)
        h = F.relu(self.fc2(F.relu(self.fc1(pooled))))
        eye = torch.eye(self.k, device=x.device)
        mat = (self.fc3(h) + eye.reshape(-1)).reshape(*h.shape[:-1], self.k,
                                                      self.k)
        transformed = torch.where(mask[..., None], x.float() @ mat, 0)
        aat = mat @ mat.transpose(-1, -2)
        ortho = ((eye - aat) ** 2).sum(dim=(-2, -1))
        return transformed, ortho.mean()


class PointNetEncoder(nn.Module):
    """forward(pts, mask) -> ([..., 1024] embedding, ortho penalty)."""

    def __init__(self, in_features: int, use_tnet: bool = True):
        super().__init__()
        self.use_tnet = use_tnet
        if use_tnet:
            self.input_tnet = TNet(in_features)
            self.feature_tnet = TNet(64)
        self.mlp1 = PointMLP(in_features, (64, 64))
        self.mlp2 = PointMLP(64, (64, 128, 1024))

    def forward(self, pts: torch.Tensor, mask: torch.Tensor):
        penalty = torch.zeros((), device=pts.device)
        x = pts
        if self.use_tnet:
            x, p1 = self.input_tnet(x, mask)
            penalty = penalty + p1
        x = self.mlp1(x, mask)
        if self.use_tnet:
            x, p2 = self.feature_tnet(x, mask)
            penalty = penalty + p2
        x = self.mlp2(x, mask)
        return masked_max(x, mask, axis=-2), penalty


class PointNetClassifier(nn.Module):
    """forward(pts, mask, generator=None) -> logits keyed by label, for one
    cloud an event ([B, P, F]) or one a plane ([B, planes, P, F], the
    planes sharing the weights; ``planes`` sizes the heads' input).

    ``tnet_ortho`` holds the last forward's TNet orthogonality penalty,
    detached.  The JAX model sows it to a ``losses`` collection that its
    supervised step never makes mutable, so it stays out of the loss."""

    def __init__(self, output_shape: Mapping[str, int], in_features: int = 4,
                 planes: int = 1, use_tnet: bool = True, head_hidden: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.p = dropout
        self.encoder = PointNetEncoder(in_features, use_tnet)
        self.keys = list(output_shape)
        self.tnet_ortho = None
        for key, n in output_shape.items():
            self.add_module(f"{key}_fc1", Dense(1024 * planes, 512))
            self.add_module(f"{key}_fc2", Dense(512, head_hidden))
            self.add_module(f"{key}_out", Dense(head_hidden, n))

    def forward(self, pts: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        emb, penalty = self.encoder(pts, mask)
        if pts.ndim == 4:  # [B, planes, 1024] -> concatenated
            emb = emb.reshape(emb.shape[0], -1)
        self.tnet_ortho = penalty.detach()
        out = {}
        for key in self.keys:
            h = F.relu(getattr(self, f"{key}_fc1")(emb))
            h = dropout(h, self.p, self.training, generator)
            h = F.relu(getattr(self, f"{key}_fc2")(h))
            out[key] = getattr(self, f"{key}_out")(h)
        return out
