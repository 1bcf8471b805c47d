"""Classification heads: per label, AvgPool over the full final grid ->
Linear(C -> hidden) -> Dropout -> LeakyReLU(0.01) -> Linear(hidden -> n).

Dropout draws from the ``torch.Generator`` the caller passes (the train
step's), so a run is reproducible from its seed; without one it draws from
the global generator."""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import SparseTensor, global_avg_pool


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator``."""
    if not training or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class DenseChainHead(nn.Module):
    def __init__(self, c_in: int, n_out: int, hidden: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(c_in, hidden)
        self.p = dropout
        self.fc2 = nn.Linear(hidden, n_out)

    def forward(self, pooled: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(self.fc1(pooled), self.p, self.training, generator)
        return self.fc2(F.leaky_relu(x, negative_slope=0.01))


class MultiHeadOutput(nn.Module):
    """One head per label key."""

    def __init__(self, c_in: int, output_shape: Mapping[str, int],
                 hidden: int = 256, dropout: float = 0.5):
        super().__init__()
        self.keys = list(output_shape)
        for key, n in output_shape.items():
            self.add_module(key, DenseChainHead(c_in, n, hidden, dropout))

    def forward(self, pooled: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, key)(pooled, generator) for key in self.keys}


def pool_encoded(st: SparseTensor) -> torch.Tensor:
    """AvgPool over the full final grid -> [B, C] in float32."""
    return global_avg_pool(st).float()
