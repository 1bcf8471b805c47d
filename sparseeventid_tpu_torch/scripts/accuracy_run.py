"""The convergence run, the port of the repository's
``scripts/accuracy_run.py``: the sparse classifier trained long enough to
learn, with its per-head validation accuracy, its loss curve, a window
against ``xla`` backend comparison over the same steps and a checkpoint
resume mid-run.

    python -m sparseeventid_tpu_torch.scripts.accuracy_run
        [--preset small|dune3d] [--steps 1500] [--xla-steps 300]
        [--xla-full] [--out FILE] [--output-dir DIR] [--device cuda|cpu]

Presets (the JAX script's ``ACC_PRESET``), each with the JAX run's seeds,
sizes and overrides:

  small   the ``synthetic`` recipe (64^3 grid) at depth 3, 2 blocks a
          level, 16 -> 64 filters, 6144 voxels and 2048 events a split, B=8,
          bf16, remat off, a checkpoint every 100 steps.  Then the ``xla``
          backend and a window run of the same length (``--xla-steps``, the
          same schedule), and a resume check 120 -> 240.
  dune3d  the ``dune3d`` recipe (depth 5, 32 -> 192 filters, the full
          1024 x 512 x 1280 grid) at B=8, bf16, remat off, a checkpoint
          every 500 steps, on 768 train and 256 val events of the JAX
          run's files (``DUNE3D_TRAIN``, ``DUNE3D_VAL``); with
          ``--xla-full`` both backends at the geometry of the JAX
          ``acc_salvage.run_compare`` (B=4, remat on, ``--xla-steps``
          steps, no validation); a resume check 60 -> 120.

The dune3d events are written once to larcv files in the temporary
directory and read back where h5py imports, as the JAX script does
(``bench.data_route``); elsewhere ``io/memory.synthetic_larcv_dataset``
serves the same batches with no file.

The loop is the JAX script's, on the port's trainer pieces
(``train/trainer.open_run``: the task, the loaders with their host plans,
the checkpoints and auto-resume): a validation point (the mean of
``VAL_POINT_BATCHES`` val batches) every 25 steps (50 at dune3d), a train
point with every metric every 25 steps, a checkpoint every
``mode.checkpoint_iteration`` steps and at the end, then a sweep of
``FINAL_BATCHES`` val batches: each head's mean and its spread across
batches.  A run whose directory holds a checkpoint resumes from it, so a
long run continues across calls.

Writes ``--out`` (default ``ACCURACY_torch.md``, at dune3d
``ACCURACY_torch_dune3d.md``; never the JAX run's ``ACCURACY.md``) and its
JSON beside it, the JAX keys (``window_train``, ``window_val``,
``window_final``, ``xla_train``, ``xla_final``, ``resume``) and
``window_final_std``, ``n_val_events``, ``device`` (the card's name and
power limit), ``window_short_train`` (the window run matched to the
``xla`` run), ``runs`` (each run's steps, seconds and dropped pairs) and
``plan_cache_mb``.  The JSON is written after every phase.  Each head's
final accuracy is held against chance and against the JAX run's mean
(``JAX_MEANS``) by a binomial z over the events swept.  A failed phase
raises.  ``OVERRIDES`` (none) is appended to every config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import load_config
from ..io.memory import SyntheticFileSpec, synthetic_larcv_dataset
from ..train.evaluate import run_dir
from ..train.trainer import open_run
from .bench import add_device_arg, card, data_route, resolve_device

PRESETS = ("small", "dune3d")
OUT = {"small": "ACCURACY_torch.md", "dune3d": "ACCURACY_torch_dune3d.md"}
OUTPUT_DIR = Path("output") / "accuracy"
BATCH = 8
CURVE_EVERY = 25  # a train point
VAL_EVERY = {"small": 25, "dune3d": 50}  # a validation point
VAL_POINT_BATCHES = 4
FINAL_BATCHES = {"small": 16, "dune3d": 32}
RESUME = {"small": (120, 240), "dune3d": (60, 120)}
SMALL_EVENTS = 2048  # data.synthetic_events, each split
# the JAX run's larcv files (accuracy_run.py:37-44)
DUNE3D_TRAIN = SyntheticFileSpec(768, (1024, 512, 1280), seed=101,
                                 mean_tracks=40.0, steps_per_track=900,
                                 max_voxels=50000)
DUNE3D_VAL = dataclasses.replace(DUNE3D_TRAIN, n_events=256, seed=202)
COMPARE_BATCH = 4  # the JAX acc_salvage.run_compare geometry
# the JAX run's plan cache: every train and val event's plans across epochs
PLAN_CACHE_MB = 32768
OVERRIDES: Tuple[str, ...] = ()

CHANCE = {
    "acc/labelcpiID": 0.5,
    "acc/labelneutID": 1 / 3,
    "acc/labelnpiID": 0.5,
    "acc/labelprotID": 1 / 3,
}
# The JAX runs' final means and the val events they swept: ACCURACY.md's
# table (small, 16 batches of 8: 87, 62, 99 and 69 of 128 events) and
# ACCURACY_dune3d.json's final_val_3000 (ACCURACY_dune3d.md's @3000 column,
# 32 batches of 8).  ACCURACY.md was measured on the JAX generator's older
# count-only events, whose neutID stops near 55%; the synthetic events of
# both packages now carry each label's topology, as ACCURACY_dune3d.md's
# did.
JAX_MEANS = {
    "small": ({"acc/labelcpiID": 87 / 128, "acc/labelneutID": 62 / 128,
               "acc/labelnpiID": 99 / 128, "acc/labelprotID": 69 / 128},
              128),
    "dune3d": ({"acc/labelcpiID": 175 / 256, "acc/labelneutID": 171 / 256,
                "acc/labelnpiID": 253 / 256, "acc/labelprotID": 122 / 256},
               256),
}
JAX_MAX_DLOSS = {"small": 0.0456, "dune3d": 0.2264}  # ACCURACY*.md


# ---- statistics


def z_vs_chance(p: float, chance: float, n: int) -> float:
    """The binomial z of an accuracy ``p`` over ``n`` events against
    ``chance``: (p - c) / sqrt(c (1 - c) / n)."""
    return (p - chance) / math.sqrt(chance * (1 - chance) / n)


def z_vs_reference(p: float, n: int, q: float, m: int) -> float:
    """The z of the difference of two binomial accuracies, ``p`` over ``n``
    events and ``q`` over ``m``: (p - q) / sqrt(p (1-p)/n + q (1-q)/m)."""
    var = p * (1 - p) / n + q * (1 - q) / m
    if var == 0:
        return 0.0 if p == q else math.copysign(math.inf, p - q)
    return (p - q) / math.sqrt(var)


# ---- configs and data


@dataclasses.dataclass
class Context:
    """What every run of one invocation shares."""

    preset: str
    device: torch.device
    output_dir: Path
    route: str = "synthetic"  # small: the config's synthetic splits
    plan_cache_mb: int = PLAN_CACHE_MB
    _memory: Dict[SyntheticFileSpec, object] = dataclasses.field(
        default_factory=dict)

    def datasets(self, cfg) -> Optional[Dict[str, object]]:
        """The splits of a dune3d run served from memory (generated once an
        invocation); None where the config names them."""
        if self.route != "memory":
            return None
        out = {}
        for split, spec in (("train", DUNE3D_TRAIN), ("val", DUNE3D_VAL)):
            if spec not in self._memory:
                self._memory[spec] = synthetic_larcv_dataset(
                    spec, max_voxels=cfg.data.max_voxels,
                    normalize=cfg.data.normalize)
            out[split] = self._memory[spec]
        return out


def host_memory_mb() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2**20


def plan_cache_budget() -> int:
    """The JAX run's 32 GiB plan cache where the host has twice that,
    else half the host's memory."""
    return min(PLAN_CACHE_MB, host_memory_mb() // 2)


def larcv_split(spec: SyntheticFileSpec, stem: str) -> str:
    """``spec``'s larcv file in the temporary directory, written once."""
    path = Path(tempfile.gettempdir()) / spec.file_name(stem)
    if not path.exists():
        print(f"generating {path} ({spec.n_events} events)...", flush=True)
        part = path.with_suffix(".part")
        spec.write(part)
        part.replace(path)
    return str(path)


def preset_overrides(ctx: Context, backend: str, run_id: str, steps: int,
                     compare: bool = False) -> Tuple[str, List[str]]:
    """-> (recipe, overrides) of a run: the JAX ``build_trainer``'s (and,
    for ``compare``, ``acc_salvage.run_compare``'s), then the data route's
    splits and ``output_dir``."""
    if ctx.preset == "small":
        return "synthetic", [
            f"run.id={run_id}",
            f"run.minibatch_size={BATCH}",
            "run.precision=bfloat16",
            "run.seed=0",
            "data.seed=0",
            f"run.length={max(1, -(-steps * BATCH // SMALL_EVENTS))}",
            "data.max_voxels=6144",
            f"data.synthetic_events={SMALL_EVENTS}",
            "encoder.depth=3",
            "encoder.blocks_per_layer=2",
            "encoder.n_initial_filters=16",
            "encoder.n_output_filters=64",
            "framework.min_capacity=512",
            f"framework.sparse_backend={backend}",
            "framework.remat=false",
            f"mode.iterations={steps}",
            "mode.checkpoint_iteration=100",
            f"output_dir={ctx.output_dir}",
        ]
    batch = COMPARE_BATCH if compare else BATCH
    n_train = DUNE3D_TRAIN.n_events
    if ctx.route == "larcv":
        train = larcv_split(DUNE3D_TRAIN, "acc_dune3d_train")
        val = larcv_split(DUNE3D_VAL, "acc_dune3d_val")
    else:
        train = val = "synthetic"
    return "dune3d", [
        f"run.id={'acc_cmp_' + backend if compare else run_id}",
        f"data.train={train}",
        f"data.val={val}",
        f"run.minibatch_size={batch}",
        "run.precision=bfloat16",
        "run.seed=0",
        "data.seed=0",
        f"run.length={max(1, -(-steps * batch // n_train))}",
        f"framework.sparse_backend={backend}",
        f"framework.remat={'true' if compare else 'false'}",
        f"mode.iterations={steps}",
        f"mode.checkpoint_iteration={100000 if compare else 500}",
        f"framework.plan_cache_mb={ctx.plan_cache_mb}",
        f"output_dir={ctx.output_dir}",
    ]


def preset_config(ctx: Context, backend: str, run_id: str, steps: int,
                  compare: bool = False, extra: Sequence[str] = ()):
    recipe, overrides = preset_overrides(ctx, backend, run_id, steps, compare)
    return load_config(recipe, [*overrides, *OVERRIDES, *extra])


# ---- the runs


@dataclasses.dataclass
class Curves:
    """One run: its train and validation points, the final sweep's mean
    and spread by metric, and what it took."""

    train: List[Dict[str, float]]
    val: List[Dict[str, float]]
    final: Dict[str, float]
    final_std: Dict[str, float]
    first_step: int
    steps: int  # train steps taken
    eval_batches: int
    dropped: int  # pairs and sites dropped over every step taken
    seconds: float

    def summary(self) -> Dict:
        return {"first_step": self.first_step, "steps": self.steps,
                "eval_batches": self.eval_batches, "dropped": self.dropped,
                "seconds": self.seconds,
                "steps_per_s": self.steps / self.seconds if self.seconds else None}


def _mean(points: Sequence[Dict[str, float]]) -> Dict[str, float]:
    return {k: float(np.mean([m[k] for m in points])) for k in points[0]}


def _train_loop(cfg, ctx: Context, tag: str, params=None,
                val_every: int = 0, final_batches: int = 0) -> Curves:
    train, val, sweep = [], [], []
    with open_run(cfg, ctx.datasets(cfg), params, ctx.device) as run:
        start, n_steps = run.state.step, run.task.n_steps
        ckpt_every = cfg.mode.checkpoint_iteration
        dropped = torch.zeros((), dtype=torch.int64, device=ctx.device)
        evals = 0
        t0 = time.perf_counter()
        for i in range(start, n_steps):
            if val_every and i % val_every == 0:
                val.append({"step": i, **_mean(
                    [run.evaluate() for _ in range(VAL_POINT_BATCHES)])})
                evals += VAL_POINT_BATCHES
            metrics = run.step(run.next_args(), i)
            dropped = dropped + metrics["overflow/dropped"]
            if i % CURVE_EVERY == 0:
                point = {k: float(v) for k, v in metrics.items()}
                train.append({"step": i, **point})
                print(f"[{tag}] step {i}: loss {point['loss/loss']:.4f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if (i + 1) % ckpt_every == 0 or i + 1 == n_steps:
                run.save()
        sweep = [run.evaluate() for _ in range(final_batches)]
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        seconds = time.perf_counter() - t0
        curves = Curves(train, val, _mean(sweep) if sweep else {},
                        {k: float(np.std([m[k] for m in sweep]))
                         for k in sweep[0]} if sweep else {},
                        start, n_steps - start if n_steps > start else 0,
                        evals + final_batches, int(dropped), seconds)
    return curves


def run_training(ctx: Context, backend: str, run_id: str, steps: int,
                 params=None) -> Curves:
    """Train ``steps`` steps (from the run's newest checkpoint, if any) with
    validation points and the final sweep."""
    cfg = preset_config(ctx, backend, run_id, steps)
    return _train_loop(cfg, ctx, backend, params, VAL_EVERY[ctx.preset],
                       FINAL_BATCHES[ctx.preset])


def run_compare(ctx: Context, backend: str, steps: int) -> Curves:
    """The dune3d comparison geometry of the JAX ``acc_salvage``: B=4,
    remat on, ``steps`` steps, train points only."""
    cfg = preset_config(ctx, backend, f"acc_cmp_{backend}", steps,
                        compare=True)
    return _train_loop(cfg, ctx, f"cmp/{backend}")


def run_resume_check(ctx: Context, run_id: str, steps_a: int,
                     steps_b: int) -> Tuple[int, int]:
    """Train ``steps_a`` steps in a fresh run directory and save, tear the
    run down, open it again at ``steps_b`` (auto-resume) and train on ->
    (the step it resumed at, the step it ended at)."""
    cfg_a = preset_config(ctx, "window", run_id, steps_a)
    shutil.rmtree(run_dir(cfg_a), ignore_errors=True)
    with open_run(cfg_a, ctx.datasets(cfg_a), None, ctx.device) as run:
        for i in range(run.state.step, run.task.n_steps):
            run.step(run.next_args(), i)
        run.save()
    cfg_b = preset_config(ctx, "window", run_id, steps_b)
    with open_run(cfg_b, ctx.datasets(cfg_b), None, ctx.device) as run:
        resumed_at = run.state.step
        for i in range(resumed_at, run.task.n_steps):
            run.step(run.next_args(), i)
        final_step = run.state.step
    return resumed_at, final_step


# ---- the report


def smoothed(curve: Sequence[Dict[str, float]], win: int = 10):
    """(step, mean loss) over ``win`` consecutive train points."""
    losses = [m["loss/loss"] for m in curve]
    steps = [m["step"] for m in curve]
    return [(steps[i + win - 1], float(np.mean(losses[i:i + win])))
            for i in range(0, len(losses) - win + 1)]


def head_rows(final: Dict[str, float], std: Dict[str, float], n: int,
              preset: str) -> List[str]:
    """The final table: each head's mean and spread, chance, and the
    binomial z against chance and against the JAX mean."""
    jax_means, n_jax = JAX_MEANS[preset]
    lines = [
        "| head | accuracy | chance | z vs chance | JAX mean | z vs JAX |",
        "|---|---|---|---|---|---|",
    ]
    for k in sorted(CHANCE):
        lines.append(
            f"| {k} | {final[k]*100:.1f}% ± {std[k]*100:.1f}% "
            f"| {CHANCE[k]*100:.1f}% | {z_vs_chance(final[k], CHANCE[k], n):+.1f}σ "
            f"| {jax_means[k]*100:.1f}% "
            f"| {z_vs_reference(final[k], n, jax_means[k], n_jax):+.1f}σ |")
    lines.append(f"| loss | {final['loss/loss']:.4f} ± "
                 f"{std['loss/loss']:.4f} | — | | | |")
    return lines


def write_report(path: Path, doc: Dict, preset: str, steps: int,
                 xla_steps: int) -> None:
    dev = doc["device"]
    n = doc["n_val_events"]
    final, std = doc["window_final"], doc["window_final_std"]
    tr_w, val_w = doc["window_train"], doc["window_val"]
    n_batches = FINAL_BATCHES[preset]
    if preset == "dune3d":
        what = ["# Accuracy evidence of the PyTorch port — dune3d recipe", "",
                "The sparse classifier at the recipe config: depth 5, 4 blocks",
                "a level, 32->192 filters, the full 1024x512x1280 grid, bf16,",
                "window kernels on host plans, batch 8; 768 train / 256 val",
                f"synthetic dune3d events, trained {steps} steps."]
    else:
        what = ["# Accuracy evidence of the PyTorch port (synthetic run)", "",
                "The sparse classifier (window kernels on host plans, bf16,",
                "batch 8, depth 3, 16->64 filters, 2048 train / 2048 val",
                "synthetic events on the synthetic recipe's 64^3 grid)",
                f"trained {steps} steps."]
    lines = what + [
        f"Card: {dev['nvidia_smi'] or dev['name']}.",
        "Chance levels: neut/prot 33.3%, cpi/npi 50%.",
        "",
        f"## Final val accuracy (mean ± std over {n_batches} val batches "
        f"of {BATCH})",
        "",
        f"z: the binomial test over the {n} val events swept, against",
        "chance (p - c) / sqrt(c(1-c)/n), and against the JAX run's mean",
        "(p - q) / sqrt(p(1-p)/n + q(1-q)/m), m its events"
        f" ({JAX_MEANS[preset][1]}).",
        "",
        *head_rows(final, std, n, preset),
        "",
        f"Step-0 train loss {tr_w[0]['loss/loss']:.4f}; final val loss "
        f"{final['loss/loss']:.4f}."
        if tr_w else "",
        "",
        f"## Loss curve (train, every {CURVE_EVERY} steps)",
        "",
        "```",
    ]
    for m in tr_w[:: max(1, len(tr_w) // 20)]:
        lines.append(f"step {m['step']:5d}  loss {m['loss/loss']:.4f}")
    lines += ["```", ""]
    if len(tr_w) >= 20:
        sm = smoothed(tr_w)
        lines += ["## Smoothed loss (250-step moving average)", "", "```"]
        for s, v in sm[:: max(1, len(sm) // 20)]:
            lines.append(f"step {s:5d}  loss {v:.4f}")
        lines += ["```", ""]
    tr_x, w_short = doc["xla_train"], doc["window_short_train"]
    if tr_x:
        lines += [
            "## Backend equivalence (window vs xla rulebook)",
            "",
            f"Same data and seed trained {xla_steps} steps on both backends"
            + (" at the recipe geometry with batch 4 and remat on (matched"
               " between the backends)" if preset == "dune3d" else "")
            + ":",
            "",
            "| step | window loss | xla loss |",
            "|---|---|---|",
        ]
        for mw, mx in zip(w_short, tr_x):
            lines.append(f"| {mw['step']} | {mw['loss/loss']:.4f} "
                         f"| {mx['loss/loss']:.4f} |")
        dloss = [abs(mw["loss/loss"] - mx["loss/loss"])
                 for mw, mx in zip(w_short, tr_x)]
        lines += ["", f"max |window - xla| loss over the horizon: "
                  f"{max(dloss):.4f} (the JAX run: {JAX_MAX_DLOSS[preset]})"]
    resume = doc["resume"]
    a, b = RESUME[preset]
    lines += [
        "",
        "## Checkpoint-resume",
        "",
        f"Run trained to step {a}, torn down, rebuilt: auto-resumed at step "
        f"{resume['resumed_at']} and continued to {resume['final_step']} "
        f"(target {b}; keep-5 GC, index file — utils/checkpoint.py).",
        "",
        f"Raw curves: see {path.with_suffix('.json').name}.",
    ]
    if preset == "dune3d" and val_w:
        lines += ["", f"## Val accuracy curve (every {VAL_EVERY[preset]} "
                  "steps)", "", "```"]
        for m in val_w[:: max(1, len(val_w) // 24)]:
            accs = " ".join(f"{k.split('label')[-1]} {m[k]*100:5.1f}%"
                            for k in sorted(m) if k.startswith("acc/"))
            lines.append(f"step {m['step']:5d}  loss {m['loss/loss']:.4f}"
                         f"  {accs}")
        lines.append("```")
    path.write_text("\n".join(lines) + "\n")


def open_context(preset: str, device: str, output_dir) -> Context:
    dev = resolve_device(device)
    ctx = Context(preset, dev, Path(output_dir))
    if preset == "dune3d":
        ctx.route = data_route()
        ctx.plan_cache_mb = plan_cache_budget()
        if ctx.plan_cache_mb != PLAN_CACHE_MB:
            print(f"# plan cache {ctx.plan_cache_mb} MB: half the host's "
                  f"{host_memory_mb()} MB (the JAX run: {PLAN_CACHE_MB})",
                  flush=True)
        print(f"# data: {ctx.route}", flush=True)
    return ctx


def device_fields(dev: torch.device) -> Dict:
    name, limit, line = card(dev)
    if line is not None:
        print(line, flush=True)
    return {"name": name, "power_limit_w": limit, "nvidia_smi": line}


def add_preset_args(p: argparse.ArgumentParser, preset: str = "small") -> None:
    p.add_argument("--preset", choices=PRESETS, default=preset,
                   help="the run's preset (JAX: ACC_PRESET)")
    p.add_argument("--output-dir", default=None,
                   help=f"the runs' output_dir (default {OUTPUT_DIR}/<preset>)")
    add_device_arg(p)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--xla-steps", type=int, default=300)
    p.add_argument("--xla-full", action="store_true",
                   help="dune3d: the backend comparison (JAX: ACC_XLA_FULL=1)")
    p.add_argument("--out", default=None,
                   help="the report (default ACCURACY_torch.md; "
                   "ACCURACY_torch_dune3d.md at dune3d)")
    add_preset_args(p)
    args = p.parse_args(argv)
    preset = args.preset
    ctx = open_context(preset, args.device,
                       args.output_dir or OUTPUT_DIR / preset)
    out = Path(args.out or OUT[preset])
    json_path = out.with_suffix(".json")
    doc = {"device": device_fields(ctx.device), "preset": preset,
           "plan_cache_mb": ctx.plan_cache_mb if preset == "dune3d" else None,
           "window_train": [], "window_val": [], "window_final": {},
           "window_final_std": {}, "n_val_events": 0, "xla_train": [],
           "xla_final": {}, "window_short_train": [], "resume": {},
           "runs": {}}

    def flush():
        json_path.write_text(json.dumps(doc))

    w = run_training(ctx, "window", "acc_window", args.steps)
    doc.update(window_train=w.train, window_val=w.val, window_final=w.final,
               window_final_std=w.final_std,
               n_val_events=FINAL_BATCHES[preset] * BATCH)
    doc["runs"]["acc_window"] = w.summary()
    flush()
    if preset == "small" or args.xla_full:
        if preset == "small":
            x = run_training(ctx, "xla", "acc_xla", args.xla_steps)
            short = run_training(ctx, "window", "acc_window_short",
                                 args.xla_steps)
        else:
            x = run_compare(ctx, "xla", args.xla_steps)
            short = run_compare(ctx, "window", args.xla_steps)
        doc.update(xla_train=x.train, xla_final=x.final,
                   window_short_train=short.train)
        doc["runs"]["acc_xla"] = x.summary()
        doc["runs"]["acc_window_short"] = short.summary()
        flush()
    resumed_at, final_step = run_resume_check(ctx, "acc_resume",
                                              *RESUME[preset])
    doc["resume"] = {"resumed_at": resumed_at, "final_step": final_step}
    flush()
    write_report(out, doc, preset, args.steps, args.xla_steps)
    print("wrote", out, flush=True)
    return doc


if __name__ == "__main__":
    main(sys.argv[1:])
