"""Structured config schema: the same tree, field names and defaults as the
JAX package's ``config/schema.py``, so recipes and dotted overrides such as
``run.minibatch_size=2 framework.sparse_backend=window`` mean the same in
both packages.

Differences from the JAX tree:

  * ``run.compute_mode`` defaults to ``CUDA``.  ``TPU`` and ``CUDA`` both
    mean "the card"; ``CPU`` is the only way onto the host.
  * ``framework.tuning`` keeps only the window sizes
    (``ops/window/query.WindowTuning``); the TPU kernel-layout switches
    have no counterpart in the CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional, Tuple


class ComputeMode(Enum):
    CPU = 0
    TPU = 1  # the card (kept so JAX-era configs load unchanged)
    CUDA = 2  # the card


class Precision(Enum):
    float32 = 0
    mixed = 1
    bfloat16 = 2
    float16 = 3


class GrowthRate(Enum):
    multiplicative = 0
    additive = 1


class DownSampling(Enum):
    convolutional = 0
    pooling = 1


class Norm(Enum):
    none = 0
    batch = 1
    layer = 2
    group = 3


class ModeKind(Enum):
    train = 0
    iotest = 1
    inference = 2
    visualize = 3


class LabelType(Enum):
    Classification = 0
    Segmentation = 1


class AccessMode(Enum):
    serial_access = 0
    random_blocks = 1
    random_events = 2


class Detector(Enum):
    dune2d = 0
    dune3d = 1
    synthetic = 2


class DistributedMode(Enum):
    DDP = 0
    horovod = 1
    shard_map = 2


class DataMode(Enum):
    dense = 0
    sparse = 1
    graph = 2


class LossBalanceScheme(Enum):
    none = 0
    even = 1
    focal = 2


class OptimizerKind(Enum):
    adam = 0
    rmsprop = 1
    sgd = 2
    adagrad = 3
    adadelta = 4
    lars = 5
    lamb = 6
    novograd = 7


# ---- leaf groups -------------------------------------------------------------

@dataclass
class LRScheduleConfig:
    name: str = ""
    peak_learning_rate: float = 3e-3


@dataclass
class OneCycleConfig(LRScheduleConfig):
    name: str = "one_cycle"
    min_learning_rate: float = 1e-5
    decay_floor: float = 1e-5
    decay_epochs: int = 5


@dataclass
class WarmupFlatDecayConfig(LRScheduleConfig):
    name: str = "standard"
    decay_floor: float = 1e-3
    decay_epochs: int = 5


@dataclass
class FlatLRConfig(LRScheduleConfig):
    name: str = "flat"


@dataclass
class OptimizerConfig:
    lr_schedule: LRScheduleConfig = field(default_factory=WarmupFlatDecayConfig)
    loss_balance_scheme: LossBalanceScheme = LossBalanceScheme.focal
    name: OptimizerKind = OptimizerKind.adam
    gradient_accumulation: int = 1
    weight_decay: float = 1e-6
    flatten_update: bool = False


@dataclass
class Run:
    distributed: bool = False
    compute_mode: ComputeMode = ComputeMode.CUDA
    length: int = 1  # epochs
    minibatch_size: int = 2
    id: Any = "debug"
    precision: Precision = Precision.float32
    profile: bool = False
    world_size: int = 1
    seed: int = 0


@dataclass
class Mode:
    name: ModeKind = ModeKind.train
    no_summary_images: bool = True
    weights_location: str = ""
    restore_encoder_only: bool = False


@dataclass
class Train(Mode):
    checkpoint_iteration: int = 50
    summary_iteration: int = 1
    logging_iteration: int = 1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    quantization_aware: bool = False
    weight_decay: float = 0.0
    iterations: int = 0  # 0 -> derive from run.length (epochs) * dataset size


@dataclass
class Inference(Mode):
    name: ModeKind = ModeKind.inference
    start_index: int = 0
    summary_iteration: int = 1
    logging_iteration: int = 1
    output_file: str = ""  # per-event softmax is written here (.npz)


@dataclass
class IOTest(Mode):
    name: ModeKind = ModeKind.iotest
    start_index: int = 0
    iterations: int = 25


@dataclass
class Visualize(Mode):
    name: ModeKind = ModeKind.visualize
    start_index: int = 0
    events: int = 8


@dataclass
class Data:
    name: str = ""
    label: bool = True
    vertex: bool = False
    mode: AccessMode = AccessMode.random_events
    seed: int = -1
    train: str = ""
    test: str = ""
    val: str = ""
    image_key: str = ""
    active: Tuple[str, ...] = ()
    normalize: bool = True
    transform1: bool = False
    transform2: bool = False
    dimension: int = 3
    images: int = 1
    mc: bool = True
    detector: Detector = Detector.synthetic
    max_voxels: int = 50000  # larcv BatchFiller MaxVoxels
    aug_max_voxels: int = 3000
    synthetic_events: int = 256  # size of the synthetic dataset


@dataclass
class KernelTuning:
    """Window sizes of the window engine (ops/window/query.WindowTuning).

    The plan builders and the conv kernels of one site set read the same
    resolved value.  None = the default."""

    window_r: Optional[int] = None  # series-conv window rows (shallow)
    window_r_strided: Optional[int] = None  # strided forward plan window rows
    window_r_initial: Optional[int] = None  # 5^d initial-conv window rows
    window_r_deep: Optional[int] = None  # series window at deep levels
    window_r_deep_from: Optional[int] = None  # first deep level


@dataclass
class Framework:
    name: str = "torch"
    mode: DataMode = DataMode.sparse
    distributed_mode: DistributedMode = DistributedMode.DDP
    oversubscribe: int = 1
    tuning: KernelTuning = field(default_factory=KernelTuning)
    # per-downsample-level shrink factor of the static COO capacity
    capacity_shrink: float = 0.5
    min_capacity: int = 1024
    remat: bool = True
    # sparse conv engine: 'window' (sorted-window CUDA kernels) or 'xla'
    # (the exact searchsorted + gather reference path, named as in the
    # JAX package)
    sparse_backend: str = "window"
    plan_cache_mb: int = 2048


@dataclass
class Repr:
    depth: int = 5
    n_initial_filters: int = 32
    n_output_filters: int = 128


@dataclass
class ConvRepresentation(Repr):
    normalization: Norm = Norm.batch
    bias: bool = True
    blocks_per_layer: int = 4
    residual: bool = True
    filter_size: int = 3
    growth_rate: GrowthRate = GrowthRate.additive
    downsampling: DownSampling = DownSampling.convolutional
    leakiness: float = 0.333  # scn.LeakyReLU default leak
    plane_merge_depth: int = -1
    per_label_final_series: bool = False
    # Static query-row bound of the window kernels as a fraction of each
    # level's capacity (1.0 = full); any excess of n_active over it is
    # counted in the dropped total.
    query_bound_frac: float = 1.0
    query_bound_growth: float = 1.6


@dataclass
class PointNetRepresentation(Repr):
    tnet: bool = True
    max_points: int = 2048


@dataclass
class DGCNNRepresentation(Repr):
    k: int = 20
    emb_dims: int = 1024
    max_points: int = 2048
    dropout: float = 0.5


@dataclass
class MLPHead:
    layers: Tuple[int, ...] = ()
    hidden: int = 256
    dropout: float = 0.5


@dataclass
class SparseEventIDConfig:
    run: Run = field(default_factory=Run)
    mode: Mode = field(default_factory=Train)
    data: Data = field(default_factory=Data)
    framework: Framework = field(default_factory=Framework)
    encoder: Repr = field(default_factory=ConvRepresentation)
    head: MLPHead = field(default_factory=MLPHead)
    output_dir: str = "output/"
    name: str = "supervised_eventID"


# ---- group registries --------------------------------------------------------

MODE_GROUP = {"train": Train, "inference": Inference, "iotest": IOTest,
              "visualize": Visualize}

ENCODER_GROUP = {
    "convnet": ConvRepresentation,
    "pointnet": PointNetRepresentation,
    "dgcnn": DGCNNRepresentation,
}

LR_SCHEDULE_GROUP = {
    "flat": FlatLRConfig,
    "one_cycle": OneCycleConfig,
    "standard": WarmupFlatDecayConfig,
}


DETECTOR_META = {
    Detector.dune2d: dict(
        n_planes=3,
        image_size=(3, 1536, 1024),  # plane axis first
        spatial=(1536, 1024),
    ),
    Detector.dune3d: dict(
        n_planes=1,
        image_size=(1024, 512, 1280),
        spatial=(1024, 512, 1280),
        physical_size=(409.6, 204.8, 516.0),
        origin=(0.0, -100.0, 0.0),
    ),
    Detector.synthetic: dict(
        n_planes=1,
        image_size=(64, 64, 64),
        spatial=(64, 64, 64),
    ),
}


def data_group(name: str) -> Data:
    if name == "dune2d":
        return Data(
            name="dune2d", dimension=2, images=3, image_key="dunevoxels",
            detector=Detector.dune2d, max_voxels=20000,
        )
    if name == "dune3d":
        return Data(
            name="dune3d", dimension=3, images=1, image_key="dunevoxels",
            detector=Detector.dune3d, max_voxels=50000,
        )
    if name == "synthetic":
        return Data(
            name="synthetic", dimension=3, images=1, image_key="dunevoxels",
            detector=Detector.synthetic, max_voxels=2048,
        )
    raise KeyError(f"unknown data group {name!r}")


# The 4 classification targets
OUTPUT_SHAPE = {
    "labelneutID": 3,
    "labelprotID": 3,
    "labelnpiID": 2,
    "labelcpiID": 2,
}


def image_size(cfg: SparseEventIDConfig) -> Tuple[int, ...]:
    if cfg.data.detector == Detector.synthetic and cfg.data.dimension == 2:
        return (3, 64, 64)
    return tuple(DETECTOR_META[cfg.data.detector]["image_size"])


def sparse_capacity(cfg: SparseEventIDConfig) -> int:
    """Level-0 sparse row capacity: MaxVoxels, times the plane count for 2D
    multiplane data."""
    n = cfg.data.max_voxels
    if cfg.data.dimension == 2:
        n *= image_size(cfg)[0]
    return n
