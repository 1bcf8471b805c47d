"""Headline benchmark, the port of the repository's ``bench.py``: dune3d
supervised training throughput (events/s on one card) on the flagship
sparse ResNet, in two occupancy regimes, printed as ONE JSON line.

    python -m sparseeventid_tpu_torch.scripts.bench [--batch 8] [--remat]
        [--qbound-frac 0.5] [--qbound-growth 1.6] [--skip-36k]
        [--peak-tflops T] [--device-plans] [--device cuda|cpu]

Shapes are the dune3d recipe's (grid 1024 x 512 x 1280, MaxVoxels 50000,
depth 5, 4 blocks a level, filters 32 -> 192), bf16, AdamW and the focal
loss, ``framework.remat=false``.  One batch of B synthetic events is made
once (``make_batch``, the JAX driver's draws) and trained on again and
again:

- the 25k regime: 40 uniform straight tracks an event at 25000 requested
  voxels, window rows 144 (``framework.tuning.window_r`` and
  ``window_r_initial``), query bound 0.5 growing by 1.6;
- the 36k regime: the detector-physics generator (``io/synthetic.py``,
  75 tracks of 900 steps), the kernels' default windows (160/176), query
  bound 1.0.

Each regime builds the train step of ``train/supervised.make_train_step``
with the host planner's plan assembly (``train/plans.HostPlanner``: the
plans of the batch built once on the host through
``io/hostio.build_window_plans``, copied to the card once), takes
``--warmup`` (24) steps, then blocks of ``--iters`` (10) steps; the host
queues a block's steps without waiting, and the block's clock stops after
one ``torch.cuda.synchronize()`` at its end, where the JAX driver fences
with ``float(metrics[...])`` (``Steps.fence``).  Blocks below 0.85 of the
running median are stragglers, and up to ``--extra-blocks`` (3) more
blocks replace them until ``--blocks`` (5) are kept (``timed_blocks``).
The value is the median of the kept blocks; every block is listed.

The useful-MAC MFU counts, on the host, the structural pairs of every conv
of the encoder times Cin x Cout, x3 for forward, dgrad and wgrad
(``useful_macs_per_train_step``), against the card's own dense bf16 peak
(``PEAK_BF16_TFLOPS``, keyed by ``torch.cuda.get_device_name()``; an
unknown card needs ``--peak-tflops``).  ``vs_baseline`` divides by an
ASSUMED 30 events/s of an A100 with a MinkowskiEngine-class ResNet (the
reference publishes no number), carried as ``baseline_assumed``.

The JSON line has the JAX driver's keys and meanings, and adds:
``device`` and ``power_limit_w`` (nvidia-smi's name and power limit; the
CPU: "cpu" and null), ``peak_tflops``; ``config.warmup`` and
``config.plans_widened`` (batches whose overflow lists the host planner
widened to hold every pair, ``HostPlanner.widened``), and
``regime_36k.blocks_kept`` and ``regime_36k.plans_widened``.
``overflow_dropped`` sums every step's dropped pairs on the card, read at
each fence (the JAX driver reads the last warm-up step's).  ``OVERRIDES``
(none) is appended to each regime's config.  Unlike the JAX driver, a
failure raises: there is no retry on other backward kernels, no error note
for a failed 36k regime and no silent switch to device plans
(``--device-plans`` asks for them, the JAX ``BENCH_HOST_PLANS=0``).

``bench_e2e.py`` and ``bench_extra.py`` share this module's helpers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import OUTPUT_SHAPE, load_config
from ..config.schema import LossBalanceScheme
from ..io.memory import SyntheticFileSpec, synthetic_larcv_dataset
from ..models import build_sparse_classifier
from ..models.encoder import GRID_QUANTUM, _round_up
from ..ops import build_sparse_tensor
from ..ops.rulebook import kernel_offsets
from ..train.evaluate import build_dataset, class_weights_of
from ..train.plans import HostPlanner
from ..train.supervised import make_train_step
from ..train.tasks import new_state
from ..train.trainer import open_run, step_generator

ASSUMED_A100_MINKOWSKI_EVENTS_PER_S = 30.0

GRID = (1024, 512, 1280)
MAX_VOXELS = 50000
ACTIVE_VOXELS = 25000  # the 25k regime's requested voxels an event
ACTIVE_VOXELS_FULL = 36000  # the full-dune3d occupancy of the 36k regime
BATCH = 8
WARMUP = 24
ITERS = 10
BLOCKS = 5  # timed blocks kept for the median
EXTRA_BLOCKS = 3  # blocks that may replace stragglers
SLOW_BLOCK_FRAC = 0.85  # keep blocks >= 85% of the running median
OVERRIDES: Tuple[str, ...] = ()  # appended to the config of each regime
WINDOWS_25K = ("framework.tuning.window_r=144",
               "framework.tuning.window_r_initial=144")

# dense bf16 tensor-core peaks (TFLOP/s, no sparsity), by
# torch.cuda.get_device_name(): NVIDIA's H100 data sheet, SXM5 part
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


# ---- helpers shared by the three drivers


def resolve_device(device: str) -> torch.device:
    """The card unless ``device`` is "cpu"; raises where no card is."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "benchmark on the host")
    return dev


def card(dev: torch.device) -> Tuple[str, Optional[float], Optional[str]]:
    """-> (device name, power limit in W, nvidia-smi's line): the card's
    (``torch.cuda.get_device_name``), or ("cpu", None, None)."""
    if dev.type != "cuda":
        return "cpu", None, None
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[dev.index or 0]
    limit = line.rsplit(",", 1)[1].strip()
    return name, float(limit.split()[0]), line


def peak_tflops(device_name: str, given: Optional[float] = None) -> float:
    """The dense bf16 peak to hold the useful MACs against: ``given``, else
    the table's entry for the card; an unknown card raises."""
    if given is not None:
        return float(given)
    if device_name not in PEAK_BF16_TFLOPS:
        raise ValueError(f"no bf16 peak known for {device_name!r}: pass "
                         "--peak-tflops")
    return PEAK_BF16_TFLOPS[device_name]


class Steps:
    """Takes train steps, ``step(*args, i)`` for the i-th, without waiting
    for the card, and sums their dropped pairs on the device; ``fence()``
    waits for every queued step and reads the sum into ``dropped``, as the
    JAX drivers' ``float(metrics[...])`` does at the end of a block."""

    def __init__(self, step: Callable, dev: torch.device):
        self.step = step
        self.dev = dev
        self.taken = 0
        self.dropped = 0
        self._dropped = 0  # a device scalar once a step ran

    def __call__(self, *args) -> None:
        metrics = self.step(*args, self.taken)
        self.taken += 1
        self._dropped = metrics["overflow/dropped"] + self._dropped

    def fence(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.dropped = int(self._dropped)


def timed_rate(run_step: Callable[[], None], n: int, batch: int,
               fence: Callable[[], None]) -> float:
    """Events/s of ``n`` calls of ``run_step``, ``batch`` events each, on
    the host clock, stopped after ``fence()``."""
    t0 = time.perf_counter()
    for _ in range(n):
        run_step()
    fence()
    return n * batch / (time.perf_counter() - t0)


def kept_blocks(rates: Sequence[float], frac: float = SLOW_BLOCK_FRAC
                ) -> List[float]:
    """The blocks at least ``frac`` of the median of ``rates``."""
    med = float(np.median(rates))
    return [r for r in rates if r >= frac * med]


def timed_blocks(run_block: Callable[[], float], blocks: int = BLOCKS,
                 extra_blocks: int = EXTRA_BLOCKS,
                 frac: float = SLOW_BLOCK_FRAC
                 ) -> Tuple[List[float], List[float]]:
    """The JAX driver's straggler filter: run blocks (``run_block`` -> its
    rate) until ``blocks`` of them are at least ``frac`` of the running
    median, at most ``blocks + extra_blocks`` -> (every rate, the kept
    ones)."""
    rates: List[float] = []
    kept: List[float] = []
    for _ in range(blocks + extra_blocks):
        rates.append(run_block())
        kept = kept_blocks(rates, frac)
        if len(kept) >= blocks:
            break
    return rates, kept


def data_route() -> str:
    """The drivers' data route: "larcv" (a file written and read through
    h5py, as the JAX drivers do) where h5py imports, else "memory"
    (``io/memory.py``)."""
    try:
        import h5py  # noqa: F401
    except ModuleNotFoundError:
        return "memory"
    return "larcv"


def split_config(spec: SyntheticFileSpec, stem: str,
                 overrides: Sequence[str], recipe: str, route: str):
    """The config of ``recipe`` with ``overrides`` whose train split is
    ``spec``'s events: a larcv file under the temporary directory, written
    once (``SyntheticFileSpec.file_name``); for the memory route the word
    ``synthetic`` (``open_split`` serves the events)."""
    if route == "larcv":
        path = Path(tempfile.gettempdir()) / spec.file_name(stem)
        if not path.exists():
            part = path.with_suffix(".part")
            spec.write(part)
            part.replace(path)
        split = str(path)
    elif route == "memory":
        split = "synthetic"
    else:
        raise ValueError(f"unknown data route {route!r}")
    return load_config(recipe, [*overrides, f"data.train={split}",
                                "data.active=[train]"])


def open_split(spec: SyntheticFileSpec, stem: str, overrides: Sequence[str],
               recipe: str, route: str):
    """-> (``split_config``, its train split): the file read by the
    config's reader, or the same events in memory.  Prints the route."""
    print(f"# data: {route} ({stem}: {spec})", flush=True)
    cfg = split_config(spec, stem, overrides, recipe, route)
    if route == "larcv":
        return cfg, build_dataset(cfg, "train")
    return cfg, synthetic_larcv_dataset(spec, max_voxels=cfg.data.max_voxels,
                                        normalize=cfg.data.normalize)


@contextlib.contextmanager
def fresh_run(cfg, dataset, dev: torch.device):
    """``open_run`` of ``cfg`` on ``dataset`` in a new run directory under
    the temporary one, removed on exit: nothing to restore, so the run
    starts from its seeded initialisation."""
    with tempfile.TemporaryDirectory() as out, open_run(
            dataclasses.replace(cfg, output_dir=out), {"train": dataset},
            device=dev) as run:
        yield run


def card_fields(dev: torch.device) -> Dict:
    name, limit, line = card(dev)
    if line is not None:
        print(line, flush=True)
    return {"device": name, "power_limit_w": limit}


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the card (default) or the host")


# ---- this driver


def useful_macs_per_train_step(coords_np: np.ndarray, cfg,
                               grid: Sequence[int] = GRID) -> int:
    """Useful MACs of one training step: the matched (in, out) pairs of
    every conv of the encoder x Cin x Cout, x3 for forward, dgrad and wgrad
    (the backward's two products walk the forward's pairs).  Pairs are
    counted on the host by a sorted-key search; the strided 2^3 downsample
    maps each input site to one output site.  ``coords_np`` i32[B, N, 3],
    rows with a negative coordinate are no site."""
    depth = cfg.encoder.depth
    bpl = cfg.encoder.blocks_per_layer
    c0 = cfg.encoder.n_initial_filters
    grid = np.asarray(grid, np.int64)

    def lin(c, g):
        return (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2]

    def pairs(sites, g, offs):
        keys = np.sort(lin(sites, g))
        n = len(keys)
        total = 0
        for off in offs:
            q = sites + off[None, :]
            valid = np.all((q >= 0) & (q < g[None, :]), axis=1)
            qk = lin(q, g)
            pos = np.minimum(np.searchsorted(keys, qk), n - 1)
            total += int((valid & (keys[pos] == qk)).sum())
        return total

    offs3 = np.asarray(kernel_offsets((3, 3, 3), centered=True), np.int64)
    offs5 = np.asarray(kernel_offsets((5, 5, 5), centered=True), np.int64)
    macs = 0
    for b in range(coords_np.shape[0]):
        sites = coords_np[b][coords_np[b][:, 0] >= 0].astype(np.int64)
        g = grid.copy()
        macs += pairs(sites, g, offs5) * 1 * c0  # the initial 5^3, 1 -> c0
        filters = c0
        for _ in range(depth):
            macs += pairs(sites, g, offs3) * filters * filters * 2 * bpl
            macs += len(sites) * filters * (filters + c0)  # the downsample
            sites = np.unique(sites // 2, axis=0)
            g = -(-g // 2)
            filters += c0
        macs += pairs(sites, g, offs3) * filters * filters * 2 * bpl
        macs += len(sites) * filters * cfg.encoder.n_output_filters  # 1x1
    return 3 * macs


def make_batch(active_voxels: int, n_tracks: Optional[int], seed: int = 0,
               batch: int = BATCH, grid: Sequence[int] = GRID,
               max_voxels: int = MAX_VOXELS, device="cpu"):
    """One batch of track-like events -> (bf16 SparseTensor on ``device``,
    int32 labels by head, mean voxels an event), the JAX driver's draws:
    ``n_tracks`` uniform straight tracks of ``active_voxels // n_tracks``
    steps each, or for ``n_tracks=None`` the detector-physics generator at
    75 tracks of 900 steps (uniform tracks at that occupancy are denser and
    shorter than real ones, and more of their pairs escape the windows)."""
    r = np.random.default_rng(seed)
    coords = np.full((batch, max_voxels, 3), -1, np.int32)
    feats = np.zeros((batch, max_voxels, 1), np.float32)
    occ = []
    if n_tracks is None:
        from ..io import SyntheticDataset, SyntheticEventConfig

        ds = SyntheticDataset(
            batch,
            SyntheticEventConfig(image_size=tuple(grid), max_voxels=max_voxels,
                                 mean_tracks=75.0, steps_per_track=900),
            seed=seed,
        )
        for b in range(batch):
            c, vals, _labs, _aux = ds.event(b)
            k = min(len(c), max_voxels)
            coords[b, :k] = c[:k]
            feats[b, :k, 0] = vals[:k]
            occ.append(k)
    else:
        extent = np.array(grid)
        per = active_voxels // n_tracks
        for b in range(batch):
            pts = []
            for _ in range(n_tracks):
                start = r.uniform(0.2, 0.8, 3) * extent
                d = r.normal(size=3)
                d /= np.linalg.norm(d)
                steps = np.arange(per)[:, None] * d[None, :] * 2.0
                pts.append(start[None, :] + steps
                           + r.normal(scale=0.6, size=(per, 3)))
            pts = np.concatenate(pts)
            np.clip(pts, 0, extent - 1, out=pts)
            c = np.unique(pts.astype(np.int32), axis=0)
            k = min(len(c), max_voxels)
            coords[b, :k] = c[:k]
            feats[b, :k, 0] = r.standard_normal(k)
            occ.append(k)
    st = build_sparse_tensor(
        torch.from_numpy(coords).to(device), torch.from_numpy(feats).to(device),
        tuple(grid), capacity=_round_up(max_voxels, GRID_QUANTUM))
    st = st.with_feats(st.feats.to(torch.bfloat16))
    labels = {k: torch.from_numpy(r.integers(0, v, batch).astype(np.int32)
                                  ).to(device)
              for k, v in OUTPUT_SHAPE.items()}
    return st, labels, int(np.mean(occ))


@dataclasses.dataclass(frozen=True)
class Settings:
    """What a run of this driver takes from its command line."""

    batch: int = BATCH
    remat: bool = False
    device_plans: bool = False
    warmup: int = WARMUP
    iters: int = ITERS
    blocks: int = BLOCKS
    extra_blocks: int = EXTRA_BLOCKS
    grid: Tuple[int, ...] = GRID
    max_voxels: int = MAX_VOXELS
    overrides: Tuple[str, ...] = ()


def regime_steps(active_voxels: int, n_tracks: Optional[int],
                 overrides: Sequence[str], qbound_frac: float,
                 qbound_growth: float, s: Settings, dev: torch.device
                 ) -> Tuple[Steps, Dict]:
    """The production train step of one occupancy regime on its one batch
    -> (``Steps`` of it, nothing run yet; the batch's ``cfg``, ``planner``
    (None on device plans), ``coords`` and ``occupancy``)."""
    cfg = load_config("dune3d", [
        f"run.minibatch_size={s.batch}",
        "run.precision=bfloat16",
        "run.distributed=false",
        "run.length=25",  # the schedule of the JAX driver: 100 steps x 25
        f"framework.remat={'true' if s.remat else 'false'}",
        f"encoder.query_bound_frac={qbound_frac}",
        f"encoder.query_bound_growth={qbound_growth}",
        f"data.max_voxels={s.max_voxels}",
        *overrides, *s.overrides,
    ])
    model = build_sparse_classifier(cfg)
    st, labels, occupancy = make_batch(active_voxels, n_tracks, 0, s.batch,
                                       s.grid, s.max_voxels, dev)
    planner = host = None
    if not s.device_plans:
        planner = HostPlanner(model.encoder, s.grid)
        host = HostPlanner.to_device(
            planner.build_coords(st.coords.cpu().numpy()), dev)
    state, lr_schedule = new_state(cfg, model, 100, None, dev)
    focal = LossBalanceScheme.focal
    step = make_train_step(
        state, focal, lr_schedule, class_weights_of(focal, dev),
        plans_builder=planner.plans if planner is not None else None)
    steps = Steps(lambda i: step(st, labels,
                                 step_generator(cfg.run.seed, i, dev), host),
                  dev)
    return steps, {"cfg": cfg, "planner": planner, "occupancy": occupancy,
                   "coords": st.coords.cpu().numpy()}


def run_regime(active_voxels: int, n_tracks: Optional[int],
               overrides: Sequence[str], qbound_frac: float,
               qbound_growth: float, s: Settings, dev: torch.device) -> Dict:
    """One occupancy regime's step on its one batch, trained again and
    again -> its steady-state events/s (the median of the kept blocks) and
    what the JSON line reports of it."""
    steps, info = regime_steps(active_voxels, n_tracks, overrides,
                               qbound_frac, qbound_growth, s, dev)
    planner = info["planner"]
    for _ in range(s.warmup):
        steps()
    steps.fence()
    rates, kept = timed_blocks(
        lambda: timed_rate(steps, s.iters, s.batch, steps.fence),
        s.blocks, s.extra_blocks)
    return {
        "events_per_s": float(np.median(kept)),
        "std": float(np.std(kept)),
        "blocks": [round(r, 2) for r in rates],
        "blocks_kept": len(kept),
        "overflow_dropped": steps.dropped,
        "occupancy_vox_per_event": info["occupancy"],
        "host_plans": planner is not None,
        "plans_widened": planner.widened if planner is not None else None,
        "remat": s.remat,
        "coords": info["coords"],
        "cfg": info["cfg"],
    }


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=BATCH,
                   help="events a step (JAX: BENCH_BATCH)")
    p.add_argument("--remat", action="store_true",
                   help="framework.remat=true (JAX: BENCH_REMAT=1)")
    p.add_argument("--qbound-frac", type=float, default=0.5,
                   help="the 25k regime's encoder.query_bound_frac "
                   "(JAX: BENCH_QBOUND_FRAC)")
    p.add_argument("--qbound-growth", type=float, default=1.6,
                   help="the 25k regime's encoder.query_bound_growth "
                   "(JAX: BENCH_QBOUND_GROWTH)")
    p.add_argument("--skip-36k", action="store_true",
                   help="run the 25k regime only (JAX: BENCH_SKIP_36K=1)")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the bf16 peak of the MFU, for a card the table "
                   "lacks (JAX: SEID_PEAK_BF16_TFLOPS)")
    p.add_argument("--device-plans", action="store_true",
                   help="build the window plans on the device (JAX: "
                   "BENCH_HOST_PLANS=0)")
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--iters", type=int, default=ITERS,
                   help="steps a timed block")
    p.add_argument("--blocks", type=int, default=BLOCKS,
                   help="timed blocks kept for the median")
    p.add_argument("--extra-blocks", type=int, default=EXTRA_BLOCKS,
                   help="blocks that may replace stragglers")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    fields = card_fields(dev)
    peak = peak_tflops(fields["device"], args.peak_tflops)
    s = Settings(batch=args.batch, remat=args.remat,
                 device_plans=args.device_plans, warmup=args.warmup,
                 iters=args.iters, blocks=args.blocks,
                 extra_blocks=args.extra_blocks, grid=GRID,
                 max_voxels=MAX_VOXELS, overrides=tuple(OVERRIDES))
    r25 = run_regime(ACTIVE_VOXELS, 40, WINDOWS_25K, args.qbound_frac,
                     args.qbound_growth, s, dev)
    r36 = None
    if not args.skip_36k:
        r36 = run_regime(ACTIVE_VOXELS_FULL, None, [], 1.0, 1.6, s, dev)

    macs = useful_macs_per_train_step(r25["coords"], r25["cfg"], s.grid)
    events_per_s = r25["events_per_s"]
    useful_flops_per_s = 2.0 * macs * events_per_s / s.batch
    out = {
        "metric": "dune3d_train_events_per_sec_per_chip",
        "value": round(events_per_s, 2),
        "unit": "events/s",
        "vs_baseline": round(
            events_per_s / ASSUMED_A100_MINKOWSKI_EVENTS_PER_S, 3),
        "baseline_assumed": ASSUMED_A100_MINKOWSKI_EVENTS_PER_S,
        "baseline_is_assumed": True,
        "std": round(r25["std"], 3),
        "blocks": r25["blocks"],
        "blocks_kept": r25["blocks_kept"],
        "mfu_useful": round(useful_flops_per_s / (peak * 1e12), 6),
        "useful_tflops": round(useful_flops_per_s / 1e12, 4),
        "overflow_dropped": r25["overflow_dropped"],
        **fields,
        "peak_tflops": peak,
        "config": {
            "batch": s.batch,
            "max_voxels": s.max_voxels,
            "active_voxels": ACTIVE_VOXELS,
            "occupancy_measured": r25["occupancy_vox_per_event"],
            "grid": list(s.grid),
            "precision": "bfloat16",
            "remat": r25["remat"],
            "host_plans": r25["host_plans"],
            "iters_per_block": s.iters,
            "window_r": 144,
            "warmup": s.warmup,
            "plans_widened": r25["plans_widened"],
        },
    }
    if r36 is not None:
        out["regime_36k"] = {
            "value": round(r36["events_per_s"], 2),
            "vs_baseline": round(
                r36["events_per_s"] / ASSUMED_A100_MINKOWSKI_EVENTS_PER_S, 3),
            "std": round(r36["std"], 3),
            "blocks": r36["blocks"],
            "blocks_kept": r36["blocks_kept"],
            "overflow_dropped": r36["overflow_dropped"],
            "occupancy_measured": r36["occupancy_vox_per_event"],
            "plans_widened": r36["plans_widened"],
            "window_r": "kernel defaults (160/176)",
            "note": "true full-dune3d occupancy; device-only step rate "
                    "(scripts/bench_e2e.py holds the end-to-end loop "
                    "numbers)",
        }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
