"""The four tasks of train and inference mode (JAX counterpart:
``Trainer._build_training`` and its ``_build_supervised``,
``_build_simclr``, ``_build_vertex_task`` and ``_build_unsupervised``),
chosen by ``cfg.name`` as the reference CLI chooses them:

  supervised_eventID    the 4-head classifier (``train/supervised.py``)
  simclr                two augmented views, one encoder, NT-Xent
                        (``train/representation.py``)
  yolo                  the encoder's coarse grid, dense, into a vertex head
                        (``train/vertex.py``)
  unsupervised_eventID  the classifier's single ``weak_label`` head on labels
                        from an energy window fitted to the split's spectrum
                        (``train/unsupervised.py``)

Each builder returns a ``Training``: the state (the model initialised from
the run's seed or loaded from ``params``, on the device, its optimizer and
schedule; a transfer run's encoder frozen), ``train_step(args, generator)``,
``eval_step(args)``, the step count, and ``prepare(batch) -> args`` on the
device.  Window plans are built on the host unless SEID_HOST_PLANS=0: for
supervised, yolo and unsupervised by the run's planner, in the loader's
thread and through its cache; for SimCLR in ``prepare``, one uncached plan
dict a view at the views' capacities (their coordinates change with every
draw).

The supervised task trains every model family (``models.build.build_model``:
sparse, dense or point-cloud input); the other three build the sparse
encoder only and raise for a dense or point-cloud config (``task_check``).

With ``framework.remat`` every task's sparse encoder recomputes its block
series in the backward.  With ``run.distributed`` every sparse model's batch
norms are sync batch norms (the dense and point-cloud ones take each rank's
own statistics, as in JAX) and SimCLR's loss gathers the views of every rank (``parallel/mesh.py``).  Each
rank builds from the same seed, fits ``unsupervised_eventID``'s window to
the whole split it is given (never to its shard, so every rank labels
alike) and augments its own events with views seeded ``run.seed + 101``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..config.schema import (
    OUTPUT_SHAPE,
    OptimizerConfig,
    SparseEventIDConfig,
    image_size,
    sparse_capacity,
)
from ..io.augment import augment_larcv_batch
from ..models import (
    build_model,
    build_sparse_classifier,
    capacity_schedule,
    init_parameters,
    model_family,
    require_sparse,
)
from ..ops.window.query import WindowTuning
from ..utils import telemetry
from ..utils.checkpoint import encoder_freeze_names, transfers_encoder
from .evaluate import (
    class_weights_of,
    feature_dtype,
    input_capacity,
    max_points,
    prepare_batch,
    to_input,
)
from .optimizers import build_optimizer
from .plans import HostPlanner, planner_for
from .representation import (
    RepresentationModel,
    make_simclr_eval_step,
    make_simclr_train_step,
)
from .schedules import build_lr_schedule
from .state import TrainState
from .supervised import make_eval_step, make_train_step
from .unsupervised import weak_labels_from_energy
from .vertex import (
    VertexModel,
    make_vertex_eval_step,
    make_vertex_predict_step,
    make_vertex_train_step,
)

logger = logging.getLogger(__name__)

TASKS = ("supervised_eventID", "simclr", "yolo", "unsupervised_eventID")
# the tasks whose loaders build the batches' plans (SimCLR's views are made
# in prepare, so are their plans)
LOADER_PLANS = ("supervised_eventID", "yolo", "unsupervised_eventID")
WEAK_LABEL_SAMPLE = 256  # events whose energies place the window, at most


class Training(NamedTuple):
    state: TrainState
    train_step: Callable  # (args, generator) -> metrics
    eval_step: Callable  # (args) -> metrics
    n_steps: int
    prepare: Callable  # (loader batch) -> args on the device
    predict: Optional[Callable] = None  # yolo: (args) -> per-event outputs


def check_task(name: str) -> None:
    if name not in TASKS:
        raise ValueError(f"unknown task name {name!r}; expected one of "
                         f"{sorted(TASKS)} (reference bin/exec.py:280-301)")


def task_check(cfg: SparseEventIDConfig) -> None:
    """Raise for a task the config cannot run: an unknown name, or a dense
    or point-cloud model under simclr, yolo or unsupervised_eventID, whose
    models are built on the sparse encoder alone.  (The JAX trainer builds
    their sparse models there too and then fails on the dense or
    point-cloud input, or on the point-cloud encoder's missing depth.)"""
    check_task(cfg.name)
    if cfg.name != "supervised_eventID":
        require_sparse(cfg, f"the {cfg.name} task")


def host_plans_of(planner: HostPlanner | None, batch, device):
    """The batch's host plans copied to ``device`` (None without a
    planner)."""
    if planner is None:
        return None
    return planner.to_device(planner.for_batch(batch), device)


def optimizer_config(cfg: SparseEventIDConfig) -> OptimizerConfig:
    """The run's optimizer settings; inference modes carry none and take
    the defaults."""
    return getattr(cfg.mode, "optimizer", None) or OptimizerConfig()


def new_state(cfg: SparseEventIDConfig, model: torch.nn.Module,
              epoch_length: int, params: Mapping[str, torch.Tensor] | None,
              device: torch.device):
    """-> (state, lr_schedule): ``model`` initialised from the run's seed or
    loaded from ``params``, on ``device``, with the run's optimizer and
    schedule.  In a transfer run the encoder's parameters are frozen: they
    need no gradient and the optimizer holds none of them, so neither its
    update nor its weight decay moves them (the JAX
    ``optax.multi_transform`` with ``set_to_zero``); its batch norms still
    update their statistics."""
    opt_cfg = optimizer_config(cfg)
    lr_schedule = build_lr_schedule(opt_cfg.lr_schedule, epoch_length,
                                    max(cfg.run.length, 1))
    if params is None:
        init_parameters(model, cfg.run.seed)
    else:
        model.load_state_dict(params)
    model.to(device)
    if transfers_encoder(cfg.mode):
        frozen = encoder_freeze_names(model)
        for name, p in model.named_parameters():
            if name in frozen:
                p.requires_grad_(False)
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer, scheduler = build_optimizer(opt_cfg, lr_schedule, trainable)
    return TrainState(model, optimizer, scheduler), lr_schedule


def step_count(cfg: SparseEventIDConfig, epoch_length: int) -> int:
    """``mode.iterations``, or ``run.length`` epochs when it is 0."""
    return (getattr(cfg.mode, "iterations", 0)
            or epoch_length * max(cfg.run.length, 1))


def build_training(cfg: SparseEventIDConfig, epoch_length: int,
                   params: Mapping[str, torch.Tensor] | None,
                   device: torch.device, planner: HostPlanner | None = None):
    """-> (state, train_step, n_steps) of the supervised task, any model
    family; with a ``planner`` the step takes the batch's host plans
    (``host_plans=``, a dict on the device)."""
    model, _ = build_model(cfg, sync_bn=cfg.run.distributed)
    state, lr_schedule = new_state(cfg, model, epoch_length, params, device)
    opt_cfg = optimizer_config(cfg)
    scheme = opt_cfg.loss_balance_scheme
    step = make_train_step(
        state, scheme, lr_schedule, class_weights_of(scheme, device),
        gradient_accumulation=opt_cfg.gradient_accumulation,
        plans_builder=planner.plans if planner is not None else None,
    )
    return state, step, step_count(cfg, epoch_length)


def _plans_builder(planner):
    return planner.plans if planner is not None else None


def _encoder_kwargs(cfg: SparseEventIDConfig, capacities):
    return dict(encoder_cfg=cfg.encoder, dimension=cfg.data.dimension,
                capacities=capacities, backend=cfg.framework.sparse_backend,
                tuning=WindowTuning.from_config(cfg.framework.tuning),
                sync_bn=cfg.run.distributed, remat=cfg.framework.remat)


def task_capacities(cfg: SparseEventIDConfig, max_voxels: int | None = None):
    """The encoder's level capacities; ``max_voxels`` replaces the data's
    budget (SimCLR views run at ``data.aug_max_voxels``), times the plane
    count for 2D multiplane data."""
    if max_voxels is None:
        n0 = sparse_capacity(cfg)
    else:
        n0 = max_voxels * (image_size(cfg)[0] if cfg.data.dimension == 2 else 1)
    return capacity_schedule(n0, cfg.encoder.depth,
                             cfg.framework.capacity_shrink,
                             cfg.framework.min_capacity)


def _supervised(cfg, dataset, grid, epoch_length, params, dev, planner):
    state, step, n_steps = build_training(cfg, epoch_length, params, dev,
                                          planner)
    scheme = optimizer_config(cfg).loss_balance_scheme
    eval_step = make_eval_step(state.model, scheme,
                               class_weights_of(scheme, dev),
                               plans_builder=_plans_builder(planner))
    mode = model_family(cfg)
    cap0, dtype = input_capacity(state.model, mode), feature_dtype(cfg)

    def prepare(batch):
        with telemetry.span("prepare.input"):
            x, labels = prepare_batch(batch, grid, cap0, dtype, dev, mode,
                                      max_points(cfg))
        return x, labels, host_plans_of(planner, batch, dev)

    return Training(state, lambda a, gen: step(a[0], a[1], gen, a[2]),
                    lambda a: eval_step(*a), n_steps, prepare)


def _energies(dataset) -> np.ndarray:
    """The split's per-event deposited energies: the dataset's own array, or
    those of its first events."""
    if getattr(dataset, "energy", None) is not None:
        return np.asarray(dataset.energy)
    sample = dataset.batch(list(range(min(len(dataset), WEAK_LABEL_SAMPLE))))
    if "energy" not in sample:
        raise KeyError("unsupervised_eventID needs per-event 'energy' "
                       "(particle_event_group energy_deposit)")
    return np.asarray(sample["energy"])


def _unsupervised(cfg, dataset, grid, epoch_length, params, dev, planner):
    lo, hi = (float(x) for x in
              weak_labels_from_energy(_energies(dataset))["window"])
    logger.info("weak-label energy window: [%.3g, %.3g]", lo, hi)
    model = build_sparse_classifier(cfg, output_shape={"weak_label": 2},
                                    sync_bn=cfg.run.distributed)
    state, lr_schedule = new_state(cfg, model, epoch_length, params, dev)
    opt_cfg = optimizer_config(cfg)
    scheme = opt_cfg.loss_balance_scheme
    pb = _plans_builder(planner)
    step = make_train_step(state, scheme, lr_schedule,
                           gradient_accumulation=opt_cfg.gradient_accumulation,
                           plans_builder=pb)
    eval_step = make_eval_step(model, scheme, plans_builder=pb)
    cap0, dtype = model.encoder.capacities[0], feature_dtype(cfg)

    def prepare(batch):
        with telemetry.span("prepare.input"):
            e = np.asarray(batch["energy"])
            weak = ((e >= lo) & (e <= hi)).astype(np.int32)
            st = to_input(batch["image"], grid, cap0, dtype, dev)
            labels = {"weak_label": torch.from_numpy(weak).to(dev)}
        return st, labels, host_plans_of(planner, batch, dev)

    return Training(state, lambda a, gen: step(a[0], a[1], gen, a[2]),
                    lambda a: eval_step(*a), step_count(cfg, epoch_length),
                    prepare)


def _vertex(cfg, dataset, grid, epoch_length, params, dev, planner):
    if cfg.data.dimension != 3:
        raise ValueError("yolo vertex finding needs 3D data")
    full_grid = tuple(int(g) for g in grid)
    anchor_grid = tuple(g // 2**cfg.encoder.depth for g in full_grid)
    model = VertexModel(**_encoder_kwargs(cfg, task_capacities(cfg)),
                        n_event_classes=OUTPUT_SHAPE["labelneutID"])
    state, lr_schedule = new_state(cfg, model, epoch_length, params, dev)
    pb = _plans_builder(planner)
    step = make_vertex_train_step(
        state, anchor_grid, full_grid, lr_schedule,
        optimizer_config(cfg).gradient_accumulation, pb)
    eval_step = make_vertex_eval_step(model, anchor_grid, full_grid, pb)
    predict = make_vertex_predict_step(model, anchor_grid, full_grid, pb)
    cap0, dtype = model.encoder.capacities[0], feature_dtype(cfg)

    def prepare(batch):
        if "vertex" not in batch:
            raise KeyError(
                "yolo task needs a per-event 'vertex' target; the dataset "
                "must provide one (synthetic does; larcv files need the "
                "particle_event_group vertex field)")
        with telemetry.span("prepare.input"):
            st = to_input(batch["image"], grid, cap0, dtype, dev)
            vertex = torch.from_numpy(
                np.asarray(batch["vertex"], np.float32)).to(dev)
            label = torch.from_numpy(
                np.asarray(batch["labelneutID"], np.int32)).to(dev)
        return st, vertex, label, host_plans_of(planner, batch, dev)

    return Training(state, lambda a, gen: step(*a, generator=gen),
                    lambda a: eval_step(*a), step_count(cfg, epoch_length),
                    prepare, predict=lambda a: predict(*a))


def augment_views(cfg: SparseEventIDConfig, grid):
    """-> view(image): one augmented view of a padded larcv image array
    (mirror, blur, translate), from a generator seeded with run.seed + 101,
    cut to the views' voxel budget; 2D multiplane data is augmented plane
    by plane in its stored (x, y) order."""
    rng = np.random.default_rng(cfg.run.seed + 101)
    vm = min(cfg.data.aug_max_voxels, cfg.data.max_voxels)

    def view(image: np.ndarray) -> np.ndarray:
        if image.ndim == 4:  # [B, planes, N, 3]
            b, p, n, f = image.shape
            dims = (int(grid[2]), int(grid[1]))
            out = augment_larcv_batch(image.reshape(b * p, n, f), dims, rng)
            out = out.reshape(b, p, n, f)
        else:
            out = augment_larcv_batch(image, tuple(int(g) for g in grid), rng)
        # augmented rows are compacted to the front: keep the first vm
        return out[..., :vm, :]

    return view


def _simclr(cfg, dataset, grid, epoch_length, params, dev, planner):
    t1, t2 = cfg.data.transform1, cfg.data.transform2
    if not (t1 or t2):
        # the reference recipes always augment both views for simclr
        logger.warning("simclr with data.transform1/2 unset; augmenting "
                       "both views")
        t1 = t2 = True
    vm = min(cfg.data.aug_max_voxels, cfg.data.max_voxels)
    model = RepresentationModel(**_encoder_kwargs(cfg, task_capacities(cfg, vm)))
    state, lr_schedule = new_state(cfg, model, epoch_length, params, dev)
    # the views' own planner: their capacities, no cache
    planner = planner_for(cfg, model.encoder, grid)
    pb = _plans_builder(planner)
    step = make_simclr_train_step(
        state, lr_schedule,
        gradient_accumulation=optimizer_config(cfg).gradient_accumulation,
        plans_builder=pb, sync=cfg.run.distributed)
    eval_step = make_simclr_eval_step(model, plans_builder=pb,
                                      sync=cfg.run.distributed)
    view = augment_views(cfg, grid)
    cap0, dtype = model.encoder.capacities[0], feature_dtype(cfg)

    def prepare(batch):
        image = batch["image"]
        with telemetry.span("prepare.input"):
            v1 = view(image) if t1 else image[..., :vm, :]
            v2 = view(image) if t2 else image[..., :vm, :]
            x1 = to_input(v1, grid, cap0, dtype, dev)
            x2 = to_input(v2, grid, cap0, dtype, dev)
        host = None
        if planner is not None:
            host = tuple(planner.to_device(planner.build(v), dev)
                         for v in (v1, v2))
        return x1, x2, host

    return Training(state, lambda a, gen: step(*a, generator=gen),
                    lambda a: eval_step(*a), step_count(cfg, epoch_length),
                    prepare)


BUILDERS: Dict[str, Callable] = {
    "supervised_eventID": _supervised,
    "simclr": _simclr,
    "yolo": _vertex,
    "unsupervised_eventID": _unsupervised,
}


def build_task(cfg: SparseEventIDConfig, dataset, grid, epoch_length: int,
               params: Mapping[str, torch.Tensor] | None,
               device: torch.device, planner: HostPlanner | None = None
               ) -> Training:
    """The ``Training`` of ``cfg.name`` on batches of ``grid``; ``dataset``
    is the split whose energies place the weak-label window; ``planner``
    the loader's (its batches carry their plans), used by every task but
    SimCLR."""
    task_check(cfg)
    return BUILDERS[cfg.name](cfg, dataset, grid, epoch_length, params,
                              device, planner)
