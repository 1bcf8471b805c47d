"""Train mode: the smallest loop that is the counterpart of the JAX
``Trainer.train`` for the supervised task on synthetic data.  It builds the
model, optimizer and schedule from the config, takes ``mode.iterations``
steps (0: ``run.length`` epochs of the train split), and logs the metrics
of each step.

Not here yet, and refused by name of the roadmap item: checkpoints and
resume, larcv files, the validation interleave, prefetch, the other tasks
and data-parallel training.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Iterator, List, Mapping

import numpy as np
import torch

from ..config.schema import AccessMode, OptimizerConfig, SparseEventIDConfig
from ..models import build_sparse_classifier, init_parameters
from .evaluate import (
    class_weights_of,
    build_dataset,
    feature_dtype,
    prepare_batch,
    resolve_device,
)
from .optimizers import build_optimizer
from .schedules import build_lr_schedule
from .state import TrainState, param_count
from .supervised import make_train_step

logger = logging.getLogger(__name__)


def batch_indices(n: int, batch_size: int, mode: AccessMode,
                  seed: int) -> Iterator[np.ndarray]:
    """The endless sequence of event-index batches of a split: serial, from
    a random start (random_blocks), or a fresh permutation per epoch
    (random_events; a batch may straddle two epochs)."""
    rng = np.random.default_rng(seed if seed >= 0 else 0)
    cursor, perm, pos = 0, None, 0
    while True:
        if mode == AccessMode.serial_access:
            yield (cursor + np.arange(batch_size)) % n
            cursor = (cursor + batch_size) % n
        elif mode == AccessMode.random_blocks:
            yield (int(rng.integers(0, n)) + np.arange(batch_size)) % n
        else:
            out = []
            while len(out) < batch_size:
                if perm is None or pos >= n:
                    perm, pos = rng.permutation(n), 0
                take = perm[pos:pos + batch_size - len(out)]
                out.extend(take.tolist())
                pos += len(take)
            yield np.asarray(out)


@dataclasses.dataclass
class TrainRun:
    """What a run of train mode leaves: the metrics of every step (plain
    floats, ``time/step_s`` the synchronised wall time of the step) and the
    final state."""

    history: List[Dict[str, float]]
    state: TrainState


def build_training(cfg: SparseEventIDConfig, epoch_length: int,
                   params: Mapping[str, torch.Tensor] | None,
                   device: torch.device):
    """-> (state, train_step, n_steps) of the supervised task."""
    opt_cfg = getattr(cfg.mode, "optimizer", None) or OptimizerConfig()
    total_epochs = max(cfg.run.length, 1)
    lr_schedule = build_lr_schedule(opt_cfg.lr_schedule, epoch_length, total_epochs)
    model = build_sparse_classifier(cfg)
    if params is None:
        init_parameters(model, cfg.run.seed)
    else:
        model.load_state_dict(params)
    model.to(device)
    optimizer, scheduler = build_optimizer(opt_cfg, lr_schedule, model.parameters())
    state = TrainState(model, optimizer, scheduler)
    scheme = opt_cfg.loss_balance_scheme
    step = make_train_step(
        state, scheme, lr_schedule, class_weights_of(scheme, device),
        gradient_accumulation=opt_cfg.gradient_accumulation,
    )
    n_steps = getattr(cfg.mode, "iterations", 0) or epoch_length * total_epochs
    return state, step, n_steps


def train(
    cfg: SparseEventIDConfig,
    dataset=None,
    params: Mapping[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
) -> TrainRun:
    """Run train mode.  ``dataset`` (``__len__``, ``batch(indices)``,
    ``batch_grid()``) defaults to the config's synthetic train split; ``params`` is a ``state_dict`` to start from, default a seeded
    random initialisation."""
    if cfg.name != "supervised_eventID":
        raise NotImplementedError(
            f"task {cfg.name!r} is not ported yet (ROADMAP: the other models "
            "and tasks)"
        )
    if cfg.mode.weights_location:
        raise NotImplementedError(
            "mode.weights_location: checkpoints are not restored yet "
            "(ROADMAP: larcv IO and checkpoints); pass params= instead"
        )
    if cfg.run.distributed:
        raise NotImplementedError(
            "run.distributed: data-parallel training is not ported yet "
            "(ROADMAP: DDP over the four cards)"
        )
    dev = resolve_device(cfg, device)
    if dataset is None:
        dataset = build_dataset(cfg, "train")
    bs = cfg.run.minibatch_size
    epoch_length = max(len(dataset) // bs, 1)
    state, step, n_steps = build_training(cfg, epoch_length, params, dev)
    logger.info("Model parameters: %s", f"{param_count(state.model):,}")
    dtype = feature_dtype(cfg)
    grid = dataset.batch_grid()
    cap0 = state.model.encoder.capacities[0]
    generator = torch.Generator(device=dev).manual_seed(cfg.run.seed + 1)
    batches = batch_indices(len(dataset), bs, cfg.data.mode, cfg.data.seed)
    log_every = getattr(cfg.mode, "logging_iteration", 1) or 1
    history = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        batch = dataset.batch(next(batches).tolist())
        st, labels = prepare_batch(batch, grid, cap0, dtype, dev)
        metrics = {k: float(v) for k, v in step(st, labels, generator).items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        metrics["time/step_s"] = time.perf_counter() - t0
        if metrics["overflow/dropped"] > 0:
            logger.warning(
                "step %d: %d conv pairs/sites dropped by static capacity; "
                "raise framework.min_capacity or data.max_voxels",
                i, int(metrics["overflow/dropped"]),
            )
        if i % log_every == 0:
            logger.info("train step %d: %s", i, metrics)
        history.append(metrics)
    return TrainRun(history, state)
