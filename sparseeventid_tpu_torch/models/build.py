"""Model assembly: the flagship sparse ResNet encoder + 4-head classifier
(JAX counterpart: ``models/build.py``; the sparse family only, which
``model_family`` holds every model of the port to)."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from ..config.schema import (
    OUTPUT_SHAPE,
    ConvRepresentation,
    DataMode,
    SparseEventIDConfig,
    sparse_capacity,
)
from ..ops import SparseTensor
from ..ops.window.query import WindowTuning
from .encoder import Encoder, capacity_schedule
from .heads import MultiHeadOutput, pool_encoded


class SparseEventClassifier(nn.Module):
    """forward(st, generator=None, plans=None) -> (logits keyed by label,
    dropped), ``dropped`` being the encoder's count of sites and conv pairs
    lost to static capacities; ``generator`` feeds the heads' dropout in
    training; ``plans`` (``ops.host_plans.EncoderPlans``) are the encoder's
    host-built plans, without which it builds them on the device;
    ``sync_bn`` makes every batch norm a sync batch norm."""

    def __init__(
        self,
        encoder_cfg: ConvRepresentation,
        output_shape: Mapping[str, int] = OUTPUT_SHAPE,
        dimension: int = 3,
        capacities: Tuple[int, ...] = (),
        head_hidden: int = 256,
        head_dropout: float = 0.5,
        backend: str = "xla",
        tuning: WindowTuning = WindowTuning(),
        sync_bn: bool = False,
    ):
        super().__init__()
        if encoder_cfg.per_label_final_series:
            raise NotImplementedError(
                "per-label final series are not ported yet (ROADMAP: the "
                "other models and tasks)"
            )
        self.encoder = Encoder(
            encoder_cfg, dimension, capacities, backend=backend, tuning=tuning,
            sync_bn=sync_bn,
        )
        self.head = MultiHeadOutput(
            encoder_cfg.n_output_filters, output_shape, head_hidden,
            head_dropout,
        )

    def forward(
        self, st: SparseTensor, generator: torch.Generator | None = None,
        plans=None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        encoded, dropped = self.encoder(st, plans)
        return self.head(pool_encoded(encoded), generator), dropped


def model_family(cfg: SparseEventIDConfig) -> str:
    """The model family of a config, as JAX's ``build_model`` picks it from
    the encoder type and ``framework.mode`` -> "sparse".  ``sparse`` and
    ``graph`` both ride the sparse engine (as in JAX); the dense and
    point-cloud families are not ported and raise."""
    if not isinstance(cfg.encoder, ConvRepresentation):
        raise TypeError(
            "the port's models require encoder=convnet: the point-cloud "
            "models (pointnet, dgcnn) are not ported yet (ROADMAP.md Queue 1: "
            "point-cloud models)")
    if cfg.framework.mode == DataMode.dense:
        raise NotImplementedError(
            "framework.mode=dense: the dense model family is not ported yet "
            "(ROADMAP.md Queue 1: dense mode)")
    return "sparse"


def build_sparse_classifier(
    cfg: SparseEventIDConfig,
    output_shape: Mapping[str, int] | None = None,
    sync_bn: bool = False,
) -> SparseEventClassifier:
    """The flagship model from a config tree, with uninitialised weights
    (see ``init_parameters``); the config must select the sparse family
    (``model_family``)."""
    model_family(cfg)
    enc = cfg.encoder
    caps = capacity_schedule(
        sparse_capacity(cfg), enc.depth, cfg.framework.capacity_shrink,
        cfg.framework.min_capacity,
    )
    return SparseEventClassifier(
        encoder_cfg=enc,
        output_shape=output_shape or OUTPUT_SHAPE,
        dimension=cfg.data.dimension,
        capacities=caps,
        head_hidden=cfg.head.hidden,
        head_dropout=cfg.head.dropout,
        backend=cfg.framework.sparse_backend,
        tuning=WindowTuning.from_config(cfg.framework.tuning),
        sync_bn=sync_bn,
    )


def _trunc_normal_fan_in(t: torch.Tensor, fan_in: int, scale: float,
                         gen: torch.Generator) -> None:
    # flax variance_scaling(scale, "fan_in", "truncated_normal"): a normal
    # truncated at 2 sigma, rescaled so the variance is scale / fan_in
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Initialise every parameter from one seeded generator, in the flax
    families: sparse conv weights [K, C, CO] He-style over K*C, Linear and
    dense conv weights LeCun-style over their inputs, biases and norm
    offsets 0, norm scales 1.  The draws differ from flax's for the same
    seed."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("b", "bias", "initial_b", "bottleneck_b"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif p.dim() == 3:  # conv weights [K, C, CO]
            cpu = torch.empty(p.shape)
            _trunc_normal_fan_in(cpu, p.shape[0] * p.shape[1], 2.0, gen)
            p.copy_(cpu)
        elif p.dim() in (2, 5):  # nn.Linear [out, in], nn.Conv3d [out, in, *k]
            cpu = torch.empty(p.shape)
            _trunc_normal_fan_in(cpu, math.prod(p.shape[1:]), 1.0, gen)
            p.copy_(cpu)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return model
