"""End-to-end dune3d training throughput, the port of the repository's
``bench_e2e.py``: the whole production path (the prefetching
``BatchLoader``, host plans built in its thread through the per-event plan
cache, the train step on the card) at full dune3d occupancy (about 36k
voxels an event):

  cold_epoch_ev_s   the first epoch, the plan cache filling
  warm_epoch_ev_s   the median of ``--warm-epochs`` (3) later epochs, plans
                    served from the cache
  device_only_ev_s  the step run again and again on ONE prepared batch at
                    the same occupancy (no loader; plans built once):
                    whether the warm epochs are bound by the card
  host read / plan-build ms of a batch, each over 5 reps after 2 warm-ups

    python -m sparseeventid_tpu_torch.scripts.bench_e2e [--out FILE]
        [--events 128] [--warm-epochs 3] [--device cuda|cpu]

The events: ``--events`` (128) dune3d events of seed 77, 75 tracks of 900
steps, at most 50000 voxels (the JAX driver's file).  Where h5py imports
they are written once to a larcv file in the temporary directory and read
by ``LarcvDataset``, as the JAX driver does; where it does not (the card's
host), ``io/memory.synthetic_larcv_dataset`` serves the same batches with
no file.  The route is printed first and reported as ``data``.

The config is the dune3d recipe at B = 8, bf16, ``framework.remat=false``;
the session is ``train/trainer.open_run``'s (the task, loader and
planner ``train`` builds) in a new run directory (``bench.fresh_run``), so
it starts from the run's seeded initialisation.  The first step, on the
first batch, is left out of every timing.  The host queues the steps of an epoch or a block without
waiting for the card; one ``torch.cuda.synchronize()`` at its end stops its
clock, where the JAX driver fences (``bench.Steps.fence``).  The host
probes build plans with a planner of their own (no cache), so the
session's cache is empty when the cold epoch starts.

Prints one JSON line with the JAX driver's keys and writes it to ``--out``
(default ``output/bench/bench_e2e.json``; the repository's
``BENCH_e2e.json`` is the JAX driver's and is never written).  Added keys:
``data``, ``device``, ``power_limit_w``, ``plans_widened`` (batches whose
overflow lists the planner widened to hold every pair).
``overflow_dropped`` sums every step's dropped pairs (the JAX driver reads
the last step's).  ``OVERRIDES`` (none) is appended to the config.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..io.memory import SyntheticFileSpec
from ..train.plans import run_planner
from .bench import Steps, add_device_arg, card_fields, data_route
from .bench import fresh_run, open_split, resolve_device, timed_rate

BATCH = 8
N_EVENTS = 128
# 75 tracks x 900 steps dedup to ~36k voxels an event: full dune3d occupancy
SPEC = dict(image_size=(1024, 512, 1280), seed=77, mean_tracks=75.0,
            steps_per_track=900, max_voxels=50000)
OUT = Path("output") / "bench" / "bench_e2e.json"
READ_REPS = 5  # timed reads and plan builds, after two warm-ups
WARM_EPOCHS = 3
DEVICE_WARMUP = 6
DEVICE_BLOCKS = 3
DEVICE_ITERS = 10
OVERRIDES: Tuple[str, ...] = ()


def run(args) -> Dict:
    dev = resolve_device(args.device)
    fields = card_fields(dev)
    route = data_route()
    spec = SyntheticFileSpec(n_events=args.events, **SPEC)
    cfg, ds = open_split(spec, "dune3d_e2e", [
        f"run.minibatch_size={BATCH}",
        "run.precision=bfloat16",
        "run.distributed=false",
        "framework.remat=false",
        "run.id=bench_e2e",
        *OVERRIDES,
    ], "dune3d", route)
    try:
        # host costs, the card out of the loop
        idx = np.arange(BATCH)
        for _ in range(2):
            batch = ds.batch(idx)
        t0 = time.perf_counter()
        for _ in range(READ_REPS):
            batch = ds.batch(idx)
        read_ms = (time.perf_counter() - t0) / READ_REPS * 1e3
        probe = run_planner(cfg, ds.batch_grid())
        plan_ms = None  # no host plans under SEID_HOST_PLANS=0
        if probe is not None:
            probe.build(batch["image"])
            t0 = time.perf_counter()
            for _ in range(READ_REPS):
                probe.build(batch["image"])
            plan_ms = round((time.perf_counter() - t0) / READ_REPS * 1e3, 1)
        occ = int(np.mean(np.sum(batch["image"][:, :, 0] > -999, axis=1)))
        print(f"occupancy ~{occ} vox/event; read {read_ms:.1f} ms/batch; "
              f"plan build {plan_ms} ms/batch", flush=True)

        with fresh_run(cfg, ds, dev) as s:
            steps = Steps(s.step, dev)
            steps(s.next_args())  # the first step, outside every timing
            steps.fence()
            per_epoch = args.events // BATCH

            def epoch() -> float:
                return timed_rate(lambda: steps(s.next_args()), per_epoch,
                                  BATCH, steps.fence)

            cold = epoch()
            warm = [epoch() for _ in range(args.warm_epochs)]
            # device only, at the same occupancy: one prepared batch
            fixed = s.next_args()
            for _ in range(DEVICE_WARMUP):
                steps(fixed)
            steps.fence()
            dev_rates = [timed_rate(lambda: steps(fixed), DEVICE_ITERS,
                                    BATCH, steps.fence)
                         for _ in range(DEVICE_BLOCKS)]
            widened = s.planner.widened if s.planner is not None else None
    finally:
        ds.close()
    warm_rate = float(np.median(warm))
    return {
        "metric": "dune3d_e2e_train_events_per_sec_per_chip",
        "value": round(warm_rate, 2),
        "unit": "events/s",
        "cold_epoch_ev_s": round(cold, 2),
        "warm_epoch_ev_s": round(warm_rate, 2),
        "warm_epoch_blocks": [round(r, 2) for r in warm],
        "device_only_ev_s": round(float(np.median(dev_rates)), 2),
        "device_only_blocks": [round(r, 2) for r in dev_rates],
        "occupancy_vox_per_event": occ,
        "host_read_ms_per_batch": round(read_ms, 1),
        "host_plan_ms_per_batch": plan_ms,
        "overflow_dropped": steps.dropped,
        "batch": BATCH,
        "n_events": args.events,
        "end_to_end": True,
        "data": route,
        **fields,
        "plans_widened": widened,
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=OUT,
                   help="the JSON file to write")
    p.add_argument("--events", type=int, default=N_EVENTS,
                   help="events of the split (an epoch)")
    p.add_argument("--warm-epochs", type=int, default=WARM_EPOCHS)
    add_device_arg(p)
    args = p.parse_args(argv)
    out = run(args)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
