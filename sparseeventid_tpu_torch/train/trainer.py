"""Train and iotest modes: the counterpart of the JAX ``Trainer`` for the
supervised task (``train``, ``iotest``).

A train run reads its splits through prefetching ``BatchLoader``s, builds
the model, optimizer and schedule from the config, restores (an
encoder-only transfer, a full restore from ``mode.weights_location``, or
the newest checkpoint of its run directory), and takes steps from the
restored step to ``mode.iterations`` (0: ``run.length`` epochs of the train
split).  Every ``VAL_CHECK_INTERVAL`` steps it evaluates one validation
batch first; it saves a checkpoint every ``mode.checkpoint_iteration``
steps and at the end, keeping 5.  As in the JAX package, a resumed run's
data stream starts again at its beginning.  Logs go to the run's
``process.log`` and, with tensorboardX, to ``tb/``.

The window plans of every batch are built on the host, in the loader's
thread, through a per-event plan cache whose line goes to the log once an
epoch (``train/plans.py``); ``SEID_HOST_PLANS=0`` builds them on the device
instead.  ``iotest`` times the same loaders, plan building included.

Not here yet, and refused by name of the roadmap item: the other tasks and
data-parallel training.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping

import numpy as np
import torch

from ..config.schema import OptimizerConfig, SparseEventIDConfig
from ..io.dataset import BatchLoader
from ..models import build_sparse_classifier, init_parameters
from ..utils.checkpoint import (
    CheckpointManager,
    encoder_freeze_names,
    restore_run,
    transfers_encoder,
)
from ..utils.logger import process_log
from ..utils.telemetry import StepTimer, SummaryWriter, format_log_message
from .evaluate import (
    build_dataset,
    class_weights_of,
    close_datasets,
    feature_dtype,
    prepare_batch,
    resolve_device,
    run_dir,
)
from .optimizers import build_optimizer
from .plans import HostPlanner, planner_for
from .schedules import build_lr_schedule
from .state import TrainState, param_count
from .supervised import make_eval_step, make_train_step

logger = logging.getLogger(__name__)

VAL_CHECK_INTERVAL = 10  # create_trainer.py:135


@dataclasses.dataclass
class TrainRun:
    """What a run of train mode leaves: the metrics of every step it took
    (plain floats; ``time/io_s`` and ``time/step_s`` the ``StepTimer``
    split), the validation metrics by step, the step it started from and
    the final state."""

    history: List[Dict[str, float]]
    state: TrainState
    first_step: int = 0
    validation: Dict[int, Dict[str, float]] = dataclasses.field(default_factory=dict)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one step, a function of (run.seed + 1, step)
    alone (the JAX step's fold_in(PRNGKey(seed + 1), step)): a resumed run
    draws the masks an uninterrupted one would."""
    entropy = np.random.SeedSequence([(seed + 1) % 2**63, step])
    return torch.Generator(device=device).manual_seed(
        int(entropy.generate_state(1, np.uint64)[0]))


def build_training(cfg: SparseEventIDConfig, epoch_length: int,
                   params: Mapping[str, torch.Tensor] | None,
                   device: torch.device, planner: HostPlanner | None = None):
    """-> (state, train_step, n_steps) of the supervised task; with a
    ``planner`` the step takes the batch's host plans (``host_plans=``, a
    dict on the device).  In a transfer run the encoder's parameters are
    frozen: they need no gradient and AdamW holds none of them, so neither
    its update nor its weight decay moves them (the JAX ``optax.multi_transform`` with
    ``set_to_zero``); its batch norms still update their statistics."""
    opt_cfg = getattr(cfg.mode, "optimizer", None) or OptimizerConfig()
    total_epochs = max(cfg.run.length, 1)
    lr_schedule = build_lr_schedule(opt_cfg.lr_schedule, epoch_length, total_epochs)
    model = build_sparse_classifier(cfg)
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
    state = TrainState(model, optimizer, scheduler)
    scheme = opt_cfg.loss_balance_scheme
    step = make_train_step(
        state, scheme, lr_schedule, class_weights_of(scheme, device),
        gradient_accumulation=opt_cfg.gradient_accumulation,
        plans_builder=planner.plans if planner is not None else None,
    )
    n_steps = getattr(cfg.mode, "iterations", 0) or epoch_length * total_epochs
    return state, step, n_steps


def make_loader(cfg: SparseEventIDConfig, dataset, transform=None) -> BatchLoader:
    return BatchLoader(
        dataset, cfg.run.minibatch_size, access_mode=cfg.data.mode,
        seed=cfg.data.seed if cfg.data.seed >= 0 else 0, transform=transform,
    )


def host_plans_of(planner: HostPlanner | None, batch, device):
    """The batch's host plans copied to ``device`` (None without a
    planner)."""
    if planner is None:
        return None
    return planner.to_device(planner.for_batch(batch), device)


def train(
    cfg: SparseEventIDConfig,
    dataset=None,
    params: Mapping[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
) -> TrainRun:
    """Run train mode.  ``dataset`` (``__len__``, ``batch(indices)``,
    ``batch_grid()``) replaces the config's splits: the run trains on it and
    validates on nothing.  ``params`` is a ``state_dict`` to start from;
    without it the run starts from a seeded random initialisation and then
    restores."""
    if cfg.name != "supervised_eventID":
        raise NotImplementedError(
            f"task {cfg.name!r} is not ported yet (ROADMAP: the other models "
            "and tasks)"
        )
    if cfg.run.distributed:
        raise NotImplementedError(
            "run.distributed: data-parallel training is not ported yet "
            "(ROADMAP: DDP over the four cards)"
        )
    dev = resolve_device(cfg, device)
    out_dir = run_dir(cfg)
    with process_log(out_dir / "process.log"):
        owned = []
        if dataset is None:
            splits = ["train"] + (["val"] if "val" in cfg.data.active else [])
            owned = [build_dataset(cfg, s) for s in splits]
            datasets = dict(zip(splits, owned))
        else:
            datasets = {"train": dataset}
        # one plan geometry for every split, the train split's grid
        grid = tuple(datasets["train"].batch_grid())
        planner = planner_for(cfg, build_sparse_classifier(cfg).encoder, grid,
                              cache=True)
        loaders = {}
        try:
            for split, ds in datasets.items():
                if planner is not None and tuple(ds.batch_grid()) != grid:
                    raise ValueError(f"split {split} has grid "
                                     f"{ds.batch_grid()}, train has {grid}")
                loaders[split] = make_loader(
                    cfg, ds, planner.transform(split) if planner else None)
            return _train(cfg, datasets, loaders, planner, params, dev, out_dir)
        finally:
            for loader in loaders.values():
                loader.stop()
            close_datasets(owned)


def _train(cfg, datasets, loaders, planner, params, dev, out_dir) -> TrainRun:
    loader, val_loader = loaders["train"], loaders.get("val")
    state, step, n_steps = build_training(cfg, len(loader), params, dev, planner)
    logger.info("Model parameters: %s", f"{param_count(state.model):,}")
    logger.info("window plans built on the %s",
                "host" if planner is not None else "device")
    ckpt = CheckpointManager(out_dir / "checkpoints")
    if params is None:
        restored = restore_run(cfg.mode, ckpt, state.model, dev,
                               state.optimizer, state.scheduler)
        if restored is not None:
            state.step = restored
    opt_cfg = getattr(cfg.mode, "optimizer", None) or OptimizerConfig()
    eval_step = make_eval_step(
        state.model, opt_cfg.loss_balance_scheme,
        class_weights_of(opt_cfg.loss_balance_scheme, dev),
        plans_builder=planner.plans if planner is not None else None)
    dtype = feature_dtype(cfg)
    cap0 = state.model.encoder.capacities[0]
    bs = cfg.run.minibatch_size
    log_every = getattr(cfg.mode, "logging_iteration", 1) or 1
    ckpt_every = getattr(cfg.mode, "checkpoint_iteration", 50) or 50
    writer = SummaryWriter(out_dir / "tb")
    run = TrainRun([], state, first_step=state.step)
    saved = None
    timer = StepTimer()
    for i in range(state.step, n_steps):
        if val_loader is not None and i % VAL_CHECK_INTERVAL == 0:
            vbatch = next(val_loader)
            vst, vlabels = prepare_batch(vbatch, datasets["val"].batch_grid(),
                                         cap0, dtype, dev)
            vm = {k: float(v) for k, v in eval_step(
                vst, vlabels, host_plans_of(planner, vbatch, dev)).items()}
            run.validation[i] = vm
            writer.write(vm, i, prefix="val/")
            logger.info(format_log_message(vm, bs, i, mode="val"))
        batch = next(loader)
        st, labels = prepare_batch(batch, datasets["train"].batch_grid(),
                                   cap0, dtype, dev)
        host = host_plans_of(planner, batch, dev)
        timer.mark_io()
        metrics = step(st, labels, step_generator(cfg.run.seed, i, dev), host)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timer.mark_step()
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["time/io_s"] = timer.io_time
        metrics["time/step_s"] = timer.step_time
        if metrics["overflow/dropped"] > 0:
            logger.warning(
                "step %d: %d conv pairs/sites dropped by static capacity; "
                "raise framework.min_capacity or data.max_voxels",
                i, int(metrics["overflow/dropped"]),
            )
        if i % log_every == 0:
            writer.write(metrics, i, prefix="train/")
            logger.info(format_log_message(metrics, bs, i, timer=timer))
        run.history.append(metrics)
        if (i + 1) % ckpt_every == 0:
            ckpt.save(state)
            saved = state.step
        if (planner is not None and planner.cache is not None
                and (i + 1) % len(loader) == 0):
            # once an epoch: a full budget stops storing without a word
            logger.info(planner.cache.stats_line())
    if saved != state.step:
        ckpt.save(state)
    writer.close()
    return run


def iotest(cfg: SparseEventIDConfig) -> Dict[str, Dict[str, float]]:
    """IO benchmark (bin/exec.py:226-267): for each active split, one
    warm-up fetch from its prefetching loader, then ``mode.iterations``
    timed fetches -> the mean ms of a fetch (the first timed one left out)
    and images/s.  The loaders build the window plans as the train loop's
    do.  Host work only: no device is touched."""
    bs = cfg.run.minibatch_size
    iterations = getattr(cfg.mode, "iterations", 25) or 25
    results = {}
    with process_log(run_dir(cfg) / "process.log"):
        encoder = build_sparse_classifier(cfg).encoder
        for split in cfg.data.active or ("train",):
            dataset = build_dataset(cfg, split)
            planner = planner_for(cfg, encoder, dataset.batch_grid(), cache=True)
            loader = make_loader(
                cfg, dataset,
                planner.transform(split) if planner is not None else None)
            try:
                next(loader)
                times = []
                for i in range(iterations):
                    t0 = time.perf_counter()
                    next(loader)
                    times.append(time.perf_counter() - t0)
                    logger.info("%s fetch %d: %.2f ms (%.1f img/s)", split, i,
                                times[-1] * 1e3, bs / times[-1])
            finally:
                loader.stop()
                close_datasets([dataset])
            mean = float(np.mean(times[1:] if len(times) > 1 else times))
            results[split] = {"mean_ms": mean * 1e3, "img_per_s": bs / mean}
            logger.info("%s: mean fetch %.2f ms, %.1f img/s", split,
                        mean * 1e3, bs / mean)
    return results
