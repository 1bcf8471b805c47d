"""Dense-mode ResNet encoder and classifier (JAX counterpart:
``models/dense.py``): the sparse encoder's macro-architecture on a dense
grid, with PyTorch's convolutions (the JAX package runs XLA's, outside
any Pallas kernel).

  initial 5^d conv 1 -> n_initial_filters
  depth x [ blocks_per_layer (residual) blocks ; stride-2 downsample ]
  final blocks, 1x1 bottleneck, tanh, mean over the grid

The input is channels-last, [B, *grid, 1], as the JAX package's; inside,
the model runs channels-first.  2D multiplane data, [B, planes, H, W, 1],
folds the planes into the batch, so the planes share the weights, and
concatenates the planes' encodings in (event, plane) order.

Everything follows flax's rules, not ``torch.nn``'s:
  * the model computes in float32 whatever the input type (flax promotes a
    bfloat16 input to its float32 parameters);
  * convolutions pad as flax's ``SAME`` (symmetric for odd kernels; the
    stride-2 kernel-2 downsample pads one at the high end of an odd size);
    the pooling downsample's max pool is ``VALID``;
  * batch norm (momentum 0.9 on the old value, eps 1e-4) takes its
    statistics over every axis but the channel, keeps the biased variance
    E[x^2] - E[x]^2, uses the running statistics in eval mode, and under
    data parallelism each rank's own (JAX gives it no ``axis_name``);
  * group norm is flax's ``GroupNorm(num_groups=1)``: per sample over the
    grid and every channel, eps 1e-6;
  * leaky ReLU is ``where(x >= 0, x, slope * x)``.

Module and parameter names are flax's (``initial``, ``series_{i}_block_{b}
.conv1.conv``, ``down_{i}``, ``down_norm_{i}``, ``final_block_{b}``,
``bottleneck``, ``{label}_fc1``), so ``convert.params_from_jax`` carries a
flax tree over as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schema import ConvRepresentation, DownSampling, GrowthRate, Norm
from .heads import dropout


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """flax's ``leaky_relu``: slope 1 at 0 (``F.leaky_relu`` takes
    ``slope`` there)."""
    return torch.where(x >= 0, x, slope * x)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax's ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``SAME`` padding on a channels-first float32
    tensor: ``weight`` [out, in, *kernel], ``bias`` [out]."""

    def __init__(self, c_in: int, c_out: int, kernel: Sequence[int],
                 stride: Sequence[int] | None = None, bias: bool = True):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(stride) if stride is not None else (1,) * len(self.kernel)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [same_padding(s, k, st) for s, k, st in
                zip(x.shape[2:], self.kernel, self.stride)]
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        if all(lo == hi for lo, hi in pads):  # the conv pads without a copy
            return conv(x, self.weight, self.bias, self.stride,
                        padding=tuple(lo for lo, _ in pads))
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return conv(F.pad(x, flat), self.weight, self.bias, self.stride)


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((1, -1) + (1,) * (ndim - 2))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-4)`` on a channels-first
    tensor: statistics over every axis but the channel."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_((1.0 - m) * mean)
                self.var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - _channel_view(mean, x.ndim)) * _channel_view(mul, x.ndim)
                + _channel_view(self.bias, x.ndim))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=1)`` (eps 1e-6) on a channels-first
    tensor: statistics per sample over the grid and every channel."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.ndim))
        shape = (-1,) + (1,) * (x.ndim - 1)
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        mul = (torch.rsqrt(var + self.eps).reshape(shape)
               * _channel_view(self.scale, x.ndim))
        return (x - mean.reshape(shape)) * mul + _channel_view(self.bias, x.ndim)


def _norm(norm: Norm, channels: int):
    if norm == Norm.batch:
        return BatchNorm(channels)
    if norm in (Norm.group, Norm.layer):
        return GroupNorm(channels)
    return None


class DenseBlock(nn.Module):
    """conv + norm + leaky ReLU."""

    def __init__(self, c_in: int, n_out: int, params: ConvRepresentation,
                 kernel: Sequence[int], activate: bool = True):
        super().__init__()
        self.slope = params.leakiness
        self.activate = activate
        self.conv = Conv(c_in, n_out, kernel, bias=params.bias)
        self.norm = _norm(params.normalization, n_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return leaky_relu(x, self.slope) if self.activate else x


class DenseResidualBlock(nn.Module):
    """conv-norm-act, conv-norm, + residual, act."""

    def __init__(self, channels: int, params: ConvRepresentation,
                 kernel: Sequence[int]):
        super().__init__()
        self.slope = params.leakiness
        self.conv1 = DenseBlock(channels, channels, params, kernel)
        self.conv2 = DenseBlock(channels, channels, params, kernel,
                                activate=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.conv2(self.conv1(x)) + x, self.slope)


class DenseEncoder(nn.Module):
    """[B, 1, *grid] float32 (channels-first) -> [B, n_output_filters]:
    tanh'd bottleneck features averaged over the grid.  ``spatial_dims`` is
    2 or 3 (the planes of 2D data are already in the batch)."""

    def __init__(self, params: ConvRepresentation, spatial_dims: int):
        super().__init__()
        p = params
        d = spatial_dims
        self.params = p
        kernel = (p.filter_size,) * d
        stride = (2,) * d
        self.initial = Conv(1, p.n_initial_filters, (5,) * d, bias=p.bias)
        self.names = ["initial"]
        filters = p.n_initial_filters

        def block(channels, name):
            mod = (DenseResidualBlock(channels, p, kernel) if p.residual
                   else DenseBlock(channels, channels, p, kernel))
            self.add_module(name, mod)
            self.names.append(name)

        for i in range(p.depth):
            for b in range(p.blocks_per_layer):
                block(filters, f"series_{i}_block_{b}")
            nxt = (filters * 2 if p.growth_rate == GrowthRate.multiplicative
                   else filters + p.n_initial_filters)
            if p.downsampling == DownSampling.convolutional:
                down = Conv(filters, nxt, stride, stride=stride, bias=False)
            else:
                down = Conv(filters, nxt, (1,) * d, bias=p.bias)
            self.add_module(f"down_{i}", down)
            self.names.append(f"down_{i}")
            norm = _norm(p.normalization, nxt)
            if norm is not None:
                self.add_module(f"down_norm_{i}", norm)
            filters = nxt
        for b in range(p.blocks_per_layer):
            block(filters, f"final_block_{b}")
        self.bottleneck = Conv(filters, p.n_output_filters, (1,) * d,
                               bias=p.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params
        pool = (F.max_pool2d if x.ndim == 4 else F.max_pool3d)
        for name in self.names:
            if name.startswith("down_"):
                if p.downsampling != DownSampling.convolutional:
                    x = pool(x, 2, 2)  # VALID: an odd edge row is dropped
                x = getattr(self, name)(x)
                norm = getattr(self, "down_norm_" + name[len("down_"):], None)
                if norm is not None:
                    x = norm(x)
                x = leaky_relu(x, p.leakiness)
            else:
                x = getattr(self, name)(x)
        x = torch.tanh(self.bottleneck(x))
        return x.mean(dim=tuple(range(2, x.ndim)))


class DenseEventClassifier(nn.Module):
    """forward(x, generator=None, plans=None) -> (logits keyed by label,
    dropped = 0).  ``x`` is [B, *grid, 1] (3D), or [B, planes, H, W, 1]
    for 2D multiplane data, in any float type; ``planes`` sizes the heads'
    input (the planes' encodings are concatenated).  ``generator`` feeds
    the heads' dropout in training; ``plans`` is accepted for the sparse
    models' signature and unused."""

    def __init__(
        self,
        encoder_cfg: ConvRepresentation,
        output_shape: Mapping[str, int],
        dimension: int = 3,
        planes: int = 1,
        head_hidden: int = 256,
        head_dropout: float = 0.5,
    ):
        super().__init__()
        self.dimension = dimension
        self.p = head_dropout
        self.encoder = DenseEncoder(encoder_cfg, dimension)
        c_in = encoder_cfg.n_output_filters * (planes if dimension == 2 else 1)
        self.keys = list(output_shape)
        for key, n in output_shape.items():
            self.add_module(f"{key}_fc1", nn.Linear(c_in, head_hidden))
            self.add_module(f"{key}_fc2", nn.Linear(head_hidden, n))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                plans=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        b = x.shape[0]
        if self.dimension == 2 and x.ndim == 5:  # fold the planes
            x = x.reshape(b * x.shape[1], *x.shape[2:])
        x = x.float().movedim(-1, 1)
        pooled = self.encoder(x).reshape(b, -1)
        out = {}
        for key in self.keys:
            h = dropout(getattr(self, f"{key}_fc1")(pooled), self.p,
                        self.training, generator)
            out[key] = getattr(self, f"{key}_fc2")(leaky_relu(h, 0.01))
        return out, torch.zeros((), dtype=torch.int64, device=x.device)
