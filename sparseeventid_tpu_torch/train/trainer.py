"""Train, iotest and visualize modes: the counterpart of the JAX
``Trainer`` (``train``, ``iotest``, ``visualize``).

A train run reads its splits through prefetching ``BatchLoader``s, builds
the task's model, optimizer and schedule from the config
(``train/tasks.py``: supervised_eventID, simclr, yolo or
unsupervised_eventID by ``cfg.name``), restores (an encoder-only transfer,
a full restore from ``mode.weights_location``, or the newest checkpoint of
its run directory), and takes steps from the restored step to
``mode.iterations`` (0: ``run.length`` epochs of the train split).  Every
``VAL_CHECK_INTERVAL`` steps it evaluates one validation batch first; it
saves a checkpoint every ``mode.checkpoint_iteration`` steps and at the
end, keeping 5.  As in the JAX package, a resumed run's data stream starts
again at its beginning.  Logs go to the run's ``process.log`` and, with
tensorboardX, to ``tb/``; with ``run.profile`` the loop runs under
``torch.profiler`` and leaves a Chrome trace under ``profile/``.
``open_run`` hands a caller that keeps its own schedule of validation
and saves (the convergence run, ``scripts/accuracy_run.py``) the run
``train`` drives, after its restore: a ``RunSession`` of the task, the
loaders, the planner and the checkpoints.  ``train_session`` hands a
caller that drives the steps itself (the benchmark drivers of
``scripts/``) the same task, loader and planner (``split_loaders``,
``open_task``), with no restore and no checkpoint.

The window plans of every batch are built on the host, in the loader's
thread, through a per-event plan cache whose line goes to the log once an
epoch (``train/plans.py``); SimCLR builds its views' plans as it makes the
views; ``SEID_HOST_PLANS=0`` builds them on the device instead.  ``iotest``
times the same loaders, plan building included.

With ``run.distributed`` the run is data parallel (``parallel/mesh.py``):
one process a device, joined from torchrun's environment.  Every loader,
the validation loader too, reads the rank's contiguous shard of its split;
every rank takes the same number of steps (the shortest shard's epoch sets
``run.length``'s count); rank 0's parameters and buffers are broadcast once
after the initialisation and the restore; only rank 0 writes
``process.log``, ``tb/``, the profiler trace and the checkpoints.  The
dropout generator of a step is the same on every rank, so masks are drawn
by position in the rank's batch (as JAX replicates its dropout key).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config.schema import OUTPUT_SHAPE, SparseEventIDConfig
from ..io.dataset import BatchLoader
from ..parallel import mesh
from ..utils import telemetry
from ..utils.checkpoint import CheckpointManager, restore_run
from ..utils.logger import process_log
from ..utils.telemetry import StepTimer, SummaryWriter, format_log_message
from .evaluate import build_dataset, close_datasets, resolve_device, run_dir
from .plans import HostPlanner, run_planner
from .state import TrainState, param_count
from .tasks import (  # noqa: F401  (build_training, host_plans_of: callers)
    LOADER_PLANS,
    Training,
    build_task,
    build_training,
    host_plans_of,
    task_check,
)

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


def make_loader(cfg: SparseEventIDConfig, dataset, transform=None) -> BatchLoader:
    """The split's prefetching loader over this rank's shard."""
    return BatchLoader(
        dataset, cfg.run.minibatch_size, access_mode=cfg.data.mode,
        seed=cfg.data.seed if cfg.data.seed >= 0 else 0,
        process_index=mesh.rank(), process_count=mesh.world(),
        transform=transform,
    )


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
    datasets = None if dataset is None else {"train": dataset}
    with open_run(cfg, datasets, params, device) as run:
        with _profiled(cfg, run.out_dir, run.device):
            return _train(run)


@dataclasses.dataclass
class TrainSession:
    """A train run's pieces for a caller that drives the steps itself (the
    benchmark drivers, ``scripts/bench_e2e.py`` and ``bench_extra.py``):
    the task, the train split's loader and planner, as ``train`` builds
    them."""

    cfg: SparseEventIDConfig
    task: Training
    loader: BatchLoader
    planner: Optional[HostPlanner]
    device: torch.device

    def next_args(self):
        """The loader's next batch, prepared on the device."""
        with telemetry.span("next_args", new_step=True):
            return self.task.prepare(next(self.loader))

    def step(self, args, i: int) -> Dict[str, torch.Tensor]:
        """Train step ``i`` on prepared ``args`` (the dropout generator of
        step ``i``, as in ``train``)."""
        with telemetry.span("step"):
            return self.task.train_step(
                args, step_generator(self.cfg.run.seed, i, self.device))


@dataclasses.dataclass
class RunSession(TrainSession):
    """A train run's pieces after its restore (``open_run``): a
    ``TrainSession`` (the task at the restored step, the train loader) with
    a loader a split, the run's checkpoints and its directory.  ``train``
    drives it, and so do callers that keep their own schedule of validation
    and saves (the convergence run of ``scripts/accuracy_run.py``)."""

    loaders: Dict[str, BatchLoader]
    ckpt: CheckpointManager
    out_dir: Path

    @property
    def state(self) -> TrainState:
        return self.task.state

    def evaluate(self, split: str = "val") -> Dict[str, float]:
        """The metrics of the split's next batch, as floats."""
        args = self.task.prepare(next(self.loaders[split]))
        return {k: float(v) for k, v in self.task.eval_step(args).items()}

    def save(self) -> Path:
        return self.ckpt.save(self.task.state)


@contextlib.contextmanager
def open_run(cfg: SparseEventIDConfig, datasets: Mapping[str, object] | None = None,
             params: Mapping[str, torch.Tensor] | None = None,
             device: torch.device | str | None = None):
    """-> a ``RunSession`` of ``cfg`` logging to the run's ``process.log``.
    ``datasets`` (split -> dataset, "train" among them) replaces the
    config's splits (default: train, and val where it is active).  With
    ``params`` (a ``state_dict``) the run starts from them; else from the
    seeded initialisation, then restored as ``restore_run`` says (an
    encoder-only transfer, a full restore, or the newest checkpoint of the
    run directory).  Under ``run.distributed`` rank 0's state is broadcast.
    The loaders stop and the datasets this call opened close on exit."""
    task_check(cfg)
    dev = resolve_device(cfg, device)
    out_dir = run_dir(cfg)
    with process_log(out_dir / "process.log"):
        owned = []
        if datasets is None:
            splits = ["train"] + (["val"] if "val" in cfg.data.active else [])
            owned = [build_dataset(cfg, s) for s in splits]
            datasets = dict(zip(splits, owned))
        try:
            with split_loaders(cfg, datasets) as (grid, planner, loaders):
                task = open_task(cfg, datasets["train"], grid,
                                 loaders["train"], params, dev, planner)
                state = task.state
                logger.info("Model parameters: %s",
                            f"{param_count(state.model):,}")
                logger.info("window plans built on the %s",
                            "host" if planner is not None else "device")
                ckpt = CheckpointManager(out_dir / "checkpoints")
                if params is None:
                    restored = restore_run(cfg.mode, ckpt, state.model, dev,
                                           state.optimizer, state.scheduler)
                    if restored is not None:
                        state.step = restored
                mesh.broadcast_module(state.model)
                yield RunSession(cfg, task, loaders["train"], planner, dev,
                                 loaders, ckpt, out_dir)
        finally:
            close_datasets(owned)


@contextlib.contextmanager
def split_loaders(cfg: SparseEventIDConfig, datasets: Mapping[str, object]):
    """-> (grid, planner, loaders): the train split's grid, the one plan
    geometry of every split; the run's ``HostPlanner`` with its plan cache
    for the tasks whose loaders build the plans (else None); a prefetching
    loader a split, each building its batches' plans in its thread.  The
    loaders stop on exit."""
    grid = tuple(datasets["train"].batch_grid())
    planner = (run_planner(cfg, grid, cache=True)
               if cfg.name in LOADER_PLANS else None)
    loaders = {}
    try:
        for split, ds in datasets.items():
            if tuple(ds.batch_grid()) != grid:
                raise ValueError(f"split {split} has grid "
                                 f"{ds.batch_grid()}, train has {grid}")
            loaders[split] = make_loader(
                cfg, ds, planner.transform(split) if planner else None)
        yield grid, planner, loaders
    finally:
        for loader in loaders.values():
            loader.stop()


def open_task(cfg: SparseEventIDConfig, dataset, grid, loader: BatchLoader,
              params, dev: torch.device, planner) -> Training:
    """The run's ``Training`` (state and step) for batches of ``loader``:
    one step count on every rank, since a rank that stepped once more
    would wait in a collective for ever."""
    epoch_length = mesh.min_across(len(loader))
    return build_task(cfg, dataset, grid, epoch_length, params, dev, planner)


@contextlib.contextmanager
def train_session(cfg: SparseEventIDConfig, dataset,
                  device: torch.device | str | None = None):
    """A ``TrainSession`` of ``cfg`` on ``dataset`` from the run's seeded
    initialisation (no restore, no checkpoint, no log file); its loader
    stops on exit."""
    task_check(cfg)
    dev = resolve_device(cfg, device)
    with split_loaders(cfg, {"train": dataset}) as (grid, planner, loaders):
        task = open_task(cfg, dataset, grid, loaders["train"], None, dev,
                         planner)
        yield TrainSession(cfg, task, loaders["train"], planner, dev)


@contextlib.contextmanager
def _profiled(cfg: SparseEventIDConfig, out_dir: Path, dev: torch.device):
    """With ``run.profile``, run the block under ``torch.profiler`` (CPU and,
    on the card, CUDA activities) and write its Chrome trace to
    ``<run dir>/profile/trace.json`` (the JAX trainer's ``jax.profiler``
    trace); the program's tracer records meanwhile, each of its spans a
    ``record_function`` range of the trace (``utils/telemetry``)."""
    if not cfg.run.profile or not mesh.is_main():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = out_dir / "profile" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, telemetry.tracing(True):
        yield
    prof.export_chrome_trace(str(path))
    logger.info("wrote the profiler trace %s", path)


def _train(run: RunSession) -> TrainRun:
    cfg, task, dev, state = run.cfg, run.task, run.device, run.state
    loader, val_loader = run.loaders["train"], run.loaders.get("val")
    planner = run.planner
    bs = cfg.run.minibatch_size
    log_every = getattr(cfg.mode, "logging_iteration", 1) or 1
    ckpt_every = getattr(cfg.mode, "checkpoint_iteration", 50) or 50
    writer = SummaryWriter(run.out_dir / "tb")
    result = TrainRun([], state, first_step=state.step)
    saved = None
    timer = StepTimer()
    for i in range(state.step, task.n_steps):
        if val_loader is not None and i % VAL_CHECK_INTERVAL == 0:
            vm = run.evaluate()
            result.validation[i] = vm
            writer.write(vm, i, prefix="val/")
            logger.info(format_log_message(vm, bs, i, mode="val"))
        args = run.next_args()
        timer.mark_io()
        metrics = run.step(args, i)
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
        result.history.append(metrics)
        if (i + 1) % ckpt_every == 0:
            run.save()
            saved = state.step
        if (planner is not None and planner.cache is not None
                and (i + 1) % len(loader) == 0):
            # once an epoch: a full budget stops storing without a word
            logger.info(planner.cache.stats_line())
    if saved != state.step:
        run.save()
    writer.close()
    return result


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
        for split in cfg.data.active or ("train",):
            dataset = build_dataset(cfg, split)
            planner = run_planner(cfg, dataset.batch_grid(), cache=True)
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


def visualize(cfg: SparseEventIDConfig) -> List[Path]:
    """Event displays (the JAX ``Trainer.visualize``; the reference CLI
    names this mode but has no method for it): ``mode.events`` events of the
    val split (else the first active split), each a PNG under
    ``<run dir>/visualize/``, charge-coloured scatter plots of the x-y, x-z
    and y-z projections for 3D data or one panel a plane for 2D multiplane
    data, with the truth labels and the deposited energy in the title.
    Host work only; needs matplotlib.  -> the files written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = run_dir(cfg) / "visualize"
    out.mkdir(parents=True, exist_ok=True)
    n_events = int(getattr(cfg.mode, "events", 8))
    active = cfg.data.active or ("train",)
    split = "val" if "val" in active else active[0]
    written = []
    with process_log(run_dir(cfg) / "process.log"):
        dataset = build_dataset(cfg, split)
        loader = make_loader(cfg, dataset)
        try:
            while len(written) < n_events:
                batch = next(loader)
                for b in range(batch["image"].shape[0]):
                    if len(written) >= n_events:
                        break
                    written.append(_event_display(
                        plt, batch, b, split, len(written), out))
                    logger.info("wrote %s", written[-1])
        finally:
            loader.stop()
            close_datasets([dataset])
    return written


def _event_display(plt, batch, b: int, split: str, index: int,
                   out: Path) -> Path:
    labels = ", ".join(f"{k.removeprefix('label')}={int(batch[k][b])}"
                       for k in sorted(OUTPUT_SHAPE) if k in batch)
    image = np.asarray(batch["image"][b])
    if image.ndim == 3:  # 2D multiplane [planes, MaxVoxels, 3]
        fig, axes = plt.subplots(1, len(image), figsize=(5 * len(image), 5))
        axes = np.atleast_1d(axes)
        for p, ax in enumerate(axes):
            live = image[p, :, -1] != -999.0
            sc = ax.scatter(image[p, live, 0], image[p, live, 1],
                            c=image[p, live, 2], s=1.5, cmap="viridis")
            ax.set_title(f"plane {p}")
            ax.set_aspect("equal")
    else:  # 3D [MaxVoxels, 4]
        live = image[:, 3] != -999.0
        c, v = image[live, :3], image[live, 3]
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        for ax, (i, j, name) in zip(
                axes, [(0, 1, "x-y"), (0, 2, "x-z"), (1, 2, "y-z")]):
            sc = ax.scatter(c[:, i], c[:, j], c=v, s=1.5, cmap="viridis")
            ax.set_title(name)
            ax.set_aspect("equal")
    fig.colorbar(sc, ax=axes[-1], label="charge")
    energy = (f"  energy={float(batch['energy'][b]):.0f}"
              if "energy" in batch else "")
    fig.suptitle(f"{split} event {index}: {labels}{energy}")
    path = out / f"{split}_event_{index:03d}.png"
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
