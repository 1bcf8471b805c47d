"""Classification heads: per label, AvgPool over the full final grid ->
Linear(C -> hidden) -> Dropout -> LeakyReLU(0.01) -> Linear(hidden -> n)."""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import SparseTensor, global_avg_pool


class DenseChainHead(nn.Module):
    def __init__(self, c_in: int, n_out: int, hidden: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(c_in, hidden)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(hidden, n_out)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.dropout(self.fc1(pooled)), negative_slope=0.01)
        return self.fc2(x)


class MultiHeadOutput(nn.Module):
    """One head per label key."""

    def __init__(self, c_in: int, output_shape: Mapping[str, int],
                 hidden: int = 256, dropout: float = 0.5):
        super().__init__()
        self.keys = list(output_shape)
        for key, n in output_shape.items():
            self.add_module(key, DenseChainHead(c_in, n, hidden, dropout))

    def forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, key)(pooled) for key in self.keys}


def pool_encoded(st: SparseTensor) -> torch.Tensor:
    """AvgPool over the full final grid -> [B, C] in float32."""
    return global_avg_pool(st).float()
