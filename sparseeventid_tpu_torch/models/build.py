"""Model assembly (JAX counterpart: ``models/build.py``): the flagship
sparse ResNet encoder + 4-head classifier, and ``build_model``, which picks
the family of a config as JAX's does: the point-cloud models for
``encoder=pointnet|dgcnn``, the dense classifier for
``framework.mode=dense``, else the sparse one (``graph`` rides the sparse
engine, as in JAX).

Every model's ``forward(x, generator=None, plans=None)`` returns (logits
keyed by label, dropped), so one train step serves them all; ``x`` is a
``SparseTensor`` (sparse), a dense [B, *grid, 1] tensor (dense) or
(points, mask) (points)."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from ..config.schema import (
    OUTPUT_SHAPE,
    ConvRepresentation,
    DataMode,
    DGCNNRepresentation,
    PointNetRepresentation,
    SparseEventIDConfig,
    image_size,
    sparse_capacity,
)
from ..ops import SparseTensor
from ..ops.engine import build_series_plan, plan_overflow_dropped
from ..ops.window.query import WindowTuning
from .blocks import SparseBlockSeries, offset_count
from .dense import DenseEventClassifier
from .dgcnn import DGCNNClassifier
from .encoder import Encoder, capacity_schedule
from .heads import DenseChainHead, MultiHeadOutput, pool_encoded
from .pointnet import PointNetClassifier

SPARSE, DENSE, POINTS = "sparse", "dense", "points"


class SparseEventClassifier(nn.Module):
    """forward(st, generator=None, plans=None) -> (logits keyed by label,
    dropped), ``dropped`` being the encoder's count of sites and conv pairs
    lost to static capacities; ``generator`` feeds the heads' dropout in
    training; ``plans`` (``ops.host_plans.EncoderPlans``) are the encoder's
    host-built plans, without which it builds them on the device;
    ``sync_bn`` makes every batch norm a sync batch norm; ``remat``
    recomputes the encoder's block series in the backward.

    With ``per_label_final_series`` (the legacy multiplane topology) each
    label runs its own block series, ``final_series_{label}``, on the
    encoder's output, then its own pool and head, ``head_{label}``.  The
    series share one plan, built on the device from the encoded sites as
    JAX builds it (so on host plans too); its kernel is (3, 3, 3) for a 2D
    model whenever ``plane_merge_depth`` >= 0, whatever ``filter_size`` is,
    as in JAX.  They are not recomputed under ``remat`` (neither are
    JAX's)."""

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
        remat: bool = False,
    ):
        super().__init__()
        self.encoder = Encoder(
            encoder_cfg, dimension, capacities, backend=backend, tuning=tuning,
            sync_bn=sync_bn, remat=remat,
        )
        self.per_label = encoder_cfg.per_label_final_series
        if not self.per_label:
            self.head = MultiHeadOutput(
                encoder_cfg.n_output_filters, output_shape, head_hidden,
                head_dropout,
            )
            return
        self.backend = backend
        f = encoder_cfg.filter_size
        if dimension == 2 and encoder_cfg.plane_merge_depth >= 0:
            self.label_kernel = (3, 3, 3)
        elif dimension == 2:
            self.label_kernel = (1, f, f)
        else:
            self.label_kernel = (f,) * dimension
        self.keys = list(output_shape)
        c = encoder_cfg.n_output_filters
        for key, n in output_shape.items():
            self.add_module(f"final_series_{key}", SparseBlockSeries(
                encoder_cfg.blocks_per_layer, c, encoder_cfg,
                offset_count(self.label_kernel), sync_bn))
            self.add_module(f"head_{key}", DenseChainHead(
                c, n, head_hidden, head_dropout))

    def forward(
        self, st: SparseTensor, generator: torch.Generator | None = None,
        plans=None,
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        encoded, dropped = self.encoder(st, plans)
        if not self.per_label:
            return self.head(pool_encoded(encoded), generator), dropped
        plan = build_series_plan(encoded, self.label_kernel,
                                 backend=self.backend)
        dropped = dropped + plan_overflow_dropped(plan)
        logits = {}
        for key in self.keys:
            branch = getattr(self, f"final_series_{key}")(encoded, plan)
            logits[key] = getattr(self, f"head_{key}")(pool_encoded(branch),
                                                       generator)
        return logits, dropped


class PointCloudWrapper(nn.Module):
    """The point-cloud models under the common signature: ``forward((points,
    mask), generator=None, plans=None)`` -> (logits, dropped = 0).  The
    model is ``inner``, as flax names it."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, batch, generator: torch.Generator | None = None,
                plans=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        pts, mask = batch
        return (self.inner(pts, mask, generator),
                torch.zeros((), dtype=torch.int64, device=pts.device))


def model_family(cfg: SparseEventIDConfig) -> str:
    """The input mode of a config's model family, as JAX's ``build_model``
    picks it: "points" for a pointnet or dgcnn encoder, "dense" for
    ``framework.mode=dense``, else "sparse" (``sparse`` and ``graph``)."""
    if isinstance(cfg.encoder, (PointNetRepresentation, DGCNNRepresentation)):
        return POINTS
    if not isinstance(cfg.encoder, ConvRepresentation):
        raise TypeError(f"unknown encoder {type(cfg.encoder).__name__}")
    if cfg.framework.mode == DataMode.dense:
        return DENSE
    return SPARSE


def require_sparse(cfg: SparseEventIDConfig, what: str) -> None:
    """Raise unless the config selects the sparse family: ``what`` (the
    SimCLR, vertex and weak-label models) is built on the sparse encoder
    alone.  The JAX trainer builds those models' sparse encoders whatever
    the family and then fails on the dense or point-cloud input."""
    family = model_family(cfg)
    if family != SPARSE:
        raise ValueError(
            f"{what} needs the sparse model family (encoder=convnet, "
            f"framework.mode=sparse|graph); this config selects the {family} "
            "family, which only the supervised_eventID task trains")


def build_sparse_classifier(
    cfg: SparseEventIDConfig,
    output_shape: Mapping[str, int] | None = None,
    sync_bn: bool = False,
) -> SparseEventClassifier:
    """The flagship model from a config tree, with uninitialised weights
    (see ``init_parameters``); the config must select the sparse family."""
    require_sparse(cfg, "the sparse classifier")
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
        remat=cfg.framework.remat,
    )


def fp32_convolutions() -> None:
    """The dense and point-cloud families compute in float32, as flax does:
    no TF32 in their cuDNN convolutions or cuBLAS matmuls (PyTorch allows
    TF32 in cuDNN by default)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_model(cfg: SparseEventIDConfig, sync_bn: bool = False):
    """-> (model, input mode), the mode "sparse", "dense" or "points", with
    uninitialised weights (see ``init_parameters``).  ``sync_bn`` reaches
    the sparse family only: the dense and point-cloud batch norms take each
    rank's own statistics, as JAX's (no ``axis_name``).  The 2D point-cloud
    and dense heads take the encodings of ``image_size(cfg)[0]`` planes.
    Building a dense or point-cloud model turns TF32 off
    (``fp32_convolutions``)."""
    family = model_family(cfg)
    if family == SPARSE:
        return build_sparse_classifier(cfg, sync_bn=sync_bn), SPARSE
    fp32_convolutions()
    planes = image_size(cfg)[0] if cfg.data.dimension == 2 else 1
    enc = cfg.encoder
    if family == DENSE:
        return DenseEventClassifier(
            enc, OUTPUT_SHAPE, dimension=cfg.data.dimension, planes=planes,
            head_hidden=cfg.head.hidden, head_dropout=cfg.head.dropout,
        ), DENSE
    # point features are (coordinates..., value)
    features = cfg.data.dimension + 1
    if isinstance(enc, PointNetRepresentation):
        inner = PointNetClassifier(
            OUTPUT_SHAPE, features, planes, use_tnet=enc.tnet,
            head_hidden=cfg.head.hidden, dropout=cfg.head.dropout)
    else:
        # the head's dropout, as JAX's build_model passes it
        inner = DGCNNClassifier(
            OUTPUT_SHAPE, features, planes, k=enc.k, emb_dims=enc.emb_dims,
            head_hidden=cfg.head.hidden, dropout=cfg.head.dropout)
    return PointCloudWrapper(inner), POINTS


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
    dense conv weights ([out, in, *kernel], 2D or 3D) LeCun-style over
    their inputs, biases and norm offsets 0, norm scales 1, and the
    parameters of a module marked ``zero_init`` (PointNet's TNet ``fc3``)
    0.  The draws differ from flax's for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    zero = {f"{mn}.{pn}" if mn else pn
            for mn, m in model.named_modules() if getattr(m, "zero_init", False)
            for pn, _ in m.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in zero or leaf in ("b", "bias", "initial_b", "bottleneck_b"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif p.dim() == 3:  # conv weights [K, C, CO]
            cpu = torch.empty(p.shape)
            _trunc_normal_fan_in(cpu, p.shape[0] * p.shape[1], 2.0, gen)
            p.copy_(cpu)
        elif p.dim() in (2, 4, 5):  # Linear [out, in], conv [out, in, *k]
            cpu = torch.empty(p.shape)
            _trunc_normal_fan_in(cpu, math.prod(p.shape[1:]), 1.0, gen)
            p.copy_(cpu)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    return model
