"""What the benchmark takes from the program under test
(``sparseeventid_tpu_torch``): its configuration loader, its reader
(``io/larcv.LarcvDataset``) and its training entry (``train/trainer.
open_run``, whose ``RunSession`` the program's own ``train`` drives: the
loader thread, the host planner and its plan cache, the step).  The
benchmark hands it raw events and weights; it reads back the prepared
batches, the step's metrics, the optimizer's state and the counters of
the planner and its cache.
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .reference import Readings

OPEN_WAIT_S = 120.0


class Split:
    """The train split the loader reads: index i serves pool event
    i % len(pool), assembled by the program's ``LarcvDataset``.  It
    records the indices of every batch it is asked for, in order (the
    loader's thread asks for one batch at a time, in the order it queues
    them).  It serves no batch before ``open_session`` opens it, so that
    the plan cache can be filled first, or before ``OPEN_WAIT_S`` have
    passed: a session that fails while it opens stops its loader, which
    must not wait for ever."""

    def __init__(self, events, labels: Dict[str, np.ndarray], length: int,
                 cfg: Dict):
        from sparseeventid_tpu_torch.io.larcv import LarcvDataset

        self.pool = len(events)
        idx = np.arange(length) % self.pool
        self.dataset = LarcvDataset.from_events(
            [events[i] for i in idx], cfg["larcv_grid"],
            int(cfg["dimension"]),
            labels={k: v[idx] for k, v in labels.items()},
            max_voxels=int(cfg["max_voxels"]),
            normalize=bool(cfg.get("normalize", True)), name="benchmark")
        self.asked: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._open = threading.Event()
        self.at_open: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.dataset)

    def batch_grid(self):
        return self.dataset.batch_grid()

    def batch(self, indices):
        self._open.wait(OPEN_WAIT_S)
        with self._lock:
            self.asked.append(np.asarray(indices, np.int64).copy())
        return self.dataset.batch(indices)

    def events_of(self, k: int) -> np.ndarray:
        """Pool rows of the k-th batch assembled."""
        return self.asked[k] % self.pool


def program_config(cfg: Dict, traffic: Dict, workload: str, seed: int,
                   out_dir: Path, device: torch.device):
    """The program's configuration of the cell: the recipe with the
    configuration's overrides and the traffic's batch, schedule length and
    access order; the run's seed for dropout and data order."""
    from sparseeventid_tpu_torch.config import load_config

    s = int(seed) % 2**31
    overrides = [
        *cfg["overrides"],
        f"data.max_voxels={int(cfg['max_voxels'])}",
        f"run.minibatch_size={int(traffic['batch'])}",
        f"run.length={int(traffic['run_length'])}",
        f"data.mode={traffic['access']}",
        f"run.seed={s}", f"data.seed={s}",
        "data.active=[train]", "run.distributed=false",
        f"output_dir={out_dir}", f"run.id={workload}",
    ]
    if device.type == "cpu":
        overrides.append("run.compute_mode=CPU")
    return load_config(cfg["recipe"], overrides)


@contextlib.contextmanager
def open_session(program_cfg, split: Split, weights, device,
                 fill_cache: bool = False):
    """The program's ``RunSession`` on ``split`` from ``weights``.  With
    ``fill_cache``, its planner first plans every event of the split into
    its plan cache (``fill_cache``), so that every batch the loader
    assembles, the first one too, takes its plans from cache hits.  The
    program's counters as the loader may start are kept as
    ``split.at_open``."""
    from sparseeventid_tpu_torch.train.trainer import open_run

    with open_run(program_cfg, {"train": split}, params=weights,
                  device=device) as run:
        try:
            if fill_cache:
                fill(run, split, program_cfg.run.minibatch_size)
            split.at_open = counters(run, split)
        finally:
            split._open.set()
        yield run


def fill(run, split: Split, batch: int) -> None:
    """Plan the split's events through the program's planner and its cache,
    ``batch`` consecutive indices at a time (the loader's batches draw
    events of different ones, so a hit joins slices planned apart)."""
    planner = run.planner
    if planner is None or planner.cache is None:
        raise RuntimeError("the program keeps no plan cache to fill")
    for start in range(0, len(split), batch):
        b = split.dataset.batch(np.arange(start, min(start + batch,
                                                      len(split))))
        planner.build(b["image"], b["index"], "train")
    if len(planner.cache) < len(split):
        raise RuntimeError(f"the plan cache holds {len(planner.cache)} of "
                           f"the split's {len(split)} events")


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t))


def checked_steps(run, n: int, weights: Dict[str, torch.Tensor], b1: float,
                  model):
    """Drive the session's first ``n`` steps through its own ``next_args``
    and ``step``, reading what the reference is held against -> (Readings,
    labels of each batch, dropped pairs).  ``model``, the cell's model
    family, reads each prepared input (``program_input``)."""
    opt = run.state.optimizer
    params = dict(run.state.model.named_parameters())
    losses, inputs, labels, grads = [], [], [], {}
    dropped = 0
    for k in range(n):
        args = run.next_args()
        inputs.append(model.program_input(args))
        labels.append({key: v.cpu().numpy() for key, v in args[1].items()})
        metrics = run.step(args, k)
        losses.append(float(metrics["loss/loss"]))
        dropped += int(metrics["overflow/dropped"])
        if k == 0:  # no first moment: the optimizer got no gradient
            grads = {name: _norm(opt.state[p].get("exp_avg")) / (1.0 - b1)
                     for name, p in params.items()}
    change = {name: float(torch.linalg.vector_norm(p.detach() - weights[name]))
              for name, p in params.items()}
    return Readings(losses, grads, change, inputs), labels, dropped


def counters(run, split: Split) -> Dict[str, int]:
    """The program's counters the per-layer readers take differences of."""
    planner = run.planner
    cache = planner.cache if planner is not None else None
    return {
        "plan_cache_hits": cache.hits if cache is not None else 0,
        "plan_cache_misses": cache.misses if cache is not None else 0,
        "plans_widened": planner.widened if planner is not None else 0,
        "batches_assembled": len(split.asked),
    }
