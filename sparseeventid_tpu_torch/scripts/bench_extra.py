"""Training throughput of the other configurations, the port of the
repository's ``bench_extra.py``: the dune2d multiplane and single-plane
sparse ResNets, PointNet, DGCNN, SimCLR, vertex finding (yolo) and
weak-label event ID, each through the whole production path (the
prefetching loader, host plans in its thread for the sparse models, the
train step on the card).  One JSON line a config:

    python -m sparseeventid_tpu_torch.scripts.bench_extra [config ...]
        [--warmup 6] [--iters 10] [--blocks 3] [--device cuda|cpu]

(default: all seven).  Each config: B = 8, bf16,
``framework.remat=false``, ``--warmup`` (6) steps, then ``--blocks`` (3)
blocks of ``--iters`` (10) steps; the host queues a block's steps without
waiting for the card, and one ``torch.cuda.synchronize()`` at its end
stops its clock, where the JAX driver fences (``bench.Steps.fence``); the
value is the median block.

The events (128 an input, seed 77, the JAX driver's settings): dune3d
events of 40 tracks of 900 steps, at most 50000 voxels; dune2d events of
40 tracks on (1536, 1536, 1024), each plane a projection of 1536 x 1024
pixels, 3 planes (multiplane) or 1 (single plane), at most 20000 voxels.
Where h5py imports they are larcv files in the temporary directory read by
``LarcvDataset``; elsewhere ``io/memory.synthetic_larcv_dataset`` serves
the same batches.  The route is printed first and reported as ``data``.

Deviations from the JAX driver, each named in the line's
``config.deviation``:
- dune2d: the JAX driver writes its dune2d files with one projection of
  3-D voxel ids, which the 2D reader turns into pixels whose value column
  is the padding (-999), so every event there has no valid pixel.  The
  port writes each plane as its own projection (``write_synthetic_larcv_
  file(..., planes=True)``), the layout of wire-plane files, so the
  dune2d configs train on real pixels.
- simclr: ``framework.capacity_shrink=0.75``.  The views' default
  capacities drop sites of these events; a forward of the first batch at
  the default capacities prints how many first.

The line has the JAX driver's keys and adds ``data``, ``device``,
``power_limit_w`` and ``plans_widened``; ``overflow_dropped`` sums every
step's dropped pairs (the JAX driver reads the last warm-up step's).
``OVERRIDES`` (none) is appended to every config.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..io.memory import SyntheticFileSpec
from ..train.trainer import train_session
from .bench import Steps, add_device_arg, card_fields, data_route
from .bench import open_split, resolve_device, split_config, timed_rate

WARMUP = 6
ITERS = 10
BLOCKS = 3
BATCH = 8
N_EVENTS = 128
OVERRIDES: Tuple[str, ...] = ()

FILES = {
    "dune2d": SyntheticFileSpec(
        N_EVENTS, (3, 1536, 1024), seed=77, dimension=2, mean_tracks=40.0,
        steps_per_track=900, max_voxels=20000, planes=True),
    "dune2d_single": SyntheticFileSpec(
        N_EVENTS, (1, 1536, 1024), seed=77, dimension=2, mean_tracks=40.0,
        steps_per_track=900, max_voxels=20000, planes=True),
    "dune3d": SyntheticFileSpec(
        N_EVENTS, (1024, 512, 1280), seed=77, dimension=3, mean_tracks=40.0,
        steps_per_track=900, max_voxels=50000),
}
SIMCLR_TASK = ["name=simclr", "data.transform1=true", "data.transform2=true"]
SIMCLR_SHRINK = "framework.capacity_shrink=0.75"
PLANES = ("each plane its own projection (the JAX driver's dune2d file "
          "holds no valid pixel)")

# name -> (recipe, the JAX driver's overrides, file, the port's deviation)
CONFIGS = {
    "dune2d_multiplane": ("dune2d", ["encoder.plane_merge_depth=2"],
                          "dune2d", PLANES),
    "dune2d_singleplane": ("dune2d", ["data.images=1"], "dune2d_single",
                           PLANES),
    "pointnet": ("dune3d", ["encoder=pointnet"], "dune3d", None),
    "dgcnn": ("dune3d", ["encoder=dgcnn"], "dune3d", None),
    # the views at the reference's 3000-voxel budget, their plans built a
    # draw (uncacheable)
    "simclr": ("dune3d", SIMCLR_TASK, "dune3d",
               f"{SIMCLR_SHRINK}: the default view capacities drop sites"),
    "vertex": ("dune3d", ["name=yolo"], "dune3d", None),
    "unsupervised": ("dune3d", ["name=unsupervised_eventID"], "dune3d", None),
}


def default_view_drops(cfg, ds, dev) -> float:
    """Sites and pairs one SimCLR forward of the first batch drops at the
    views' default capacities."""
    with train_session(cfg, ds, dev) as s:
        return float(s.task.eval_step(s.next_args())["overflow/dropped"])


def bench_one(name: str, args) -> Dict:
    recipe, overrides, fkey, deviation = CONFIGS[name]
    dev = resolve_device(args.device)
    fields = card_fields(dev)
    route = data_route()
    common = [
        f"run.minibatch_size={BATCH}",
        "run.precision=bfloat16",
        "run.distributed=false",
        "framework.remat=false",
        f"run.id=bench_extra_{name}",
        *OVERRIDES,
    ]
    ran = list(overrides) + ([SIMCLR_SHRINK] if name == "simclr" else [])
    cfg, ds = open_split(FILES[fkey], fkey, [*ran, *common], recipe, route)
    try:
        if name == "simclr":
            default_cfg = split_config(FILES[fkey], fkey,
                                       [*overrides, *common], recipe, route)
            drops = default_view_drops(default_cfg, ds, dev)
            print(json.dumps({"simclr_default_capacities": True,
                              "overflow_dropped": drops}), flush=True)
        with train_session(cfg, ds, dev) as s:
            steps = Steps(s.step, dev)
            for _ in range(args.warmup):
                steps(s.next_args())
            steps.fence()
            rates = [timed_rate(lambda: steps(s.next_args()), args.iters,
                                BATCH, steps.fence)
                     for _ in range(args.blocks)]
            widened = s.planner.widened if s.planner is not None else None
    finally:
        ds.close()
    out = {
        "metric": f"{name}_train_events_per_sec_per_chip",
        "value": round(float(np.median(rates)), 2),
        "unit": "events/s",
        "vs_baseline": None,  # the reference publishes no number for these
        "blocks": [round(r, 2) for r in rates],
        "overflow_dropped": steps.dropped,
        "config": {
            "batch": BATCH,
            "recipe": recipe,
            "overrides": ran,
            "end_to_end": True,  # the loader and the host plans included
            "deviation": deviation,
        },
        "data": route,
        **fields,
        "plans_widened": widened,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="*",
                   help=f"configs to run, of {', '.join(CONFIGS)} "
                   "(default: all)")
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--blocks", type=int, default=BLOCKS)
    add_device_arg(p)
    args = p.parse_args(argv)
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        p.error(f"unknown configs {unknown}; known: {list(CONFIGS)}")
    return [bench_one(n, args) for n in args.configs or list(CONFIGS)]


if __name__ == "__main__":
    main(sys.argv[1:])
