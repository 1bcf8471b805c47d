"""Extend a convergence run, the port of the repository's
``scripts/acc_extend.py``: auto-resume ``accuracy_run``'s ``acc_window`` run
from its newest checkpoint and train it on to ``--steps`` with the same
recipe (``run.length`` derived from ``--steps``, so the schedule reaches its
decay floor), merge the new train curve into ``--json-in`` (its points
below the resumed step kept), run the full validation sweep again and
write ``--out``.

    python -m sparseeventid_tpu_torch.scripts.acc_extend [--steps 6000]
        [--out ACCURACY_torch_dune3d.md] [--json-in ACCURACY_torch_dune3d.json]
        [--preset dune3d|small] [--output-dir DIR] [--device cuda|cpu]

``--json-in`` is a JSON of ``accuracy_run`` (``window_train``,
``window_final``, ...) or of an earlier extension (the JAX tool's keys:
``train_window``, ``final_val``, ``final_val_std``, ``compare_xla``,
``compare_window``, ``resume`` as [resumed at, final step]); it is
rewritten with the latter keys, beside the ones it had.  A checkpoint is
saved and the JSON written every 500 steps, so a cut run loses at most
that much.  The run must resume: a run directory with no checkpoint
raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..train.trainer import open_run
from . import accuracy_run as acc

SAVE_EVERY = 500


def extension_doc(doc: Dict) -> Dict:
    """``doc`` with the extension's keys: an ``accuracy_run`` JSON's curves
    and results under the JAX ``acc_extend`` names."""
    out = dict(doc)
    if "window_train" in doc and "train_window" not in doc:
        out["train_window"] = doc["window_train"]
        out["final_val"] = doc["window_final"]
        out["final_val_std"] = doc.get("window_final_std", {})
        out["compare_xla"] = doc.get("xla_train", [])
        out["compare_window"] = doc.get("window_short_train", [])
        resume = doc.get("resume") or {}
        if resume:
            out["resume"] = [resume["resumed_at"], resume["final_step"]]
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--out", default=None,
                   help="the report (default ACCURACY_torch_dune3d.md)")
    p.add_argument("--json-in", default=None,
                   help="the run's JSON (default: --out's, .json)")
    acc.add_preset_args(p, preset="dune3d")
    args = p.parse_args(argv)
    preset = args.preset
    ctx = acc.open_context(preset, args.device,
                           args.output_dir or acc.OUTPUT_DIR / preset)
    out = Path(args.out or acc.OUT[preset])
    json_in = Path(args.json_in or out.with_suffix(".json"))
    prev = extension_doc(json.loads(json_in.read_text()))

    cfg = acc.preset_config(ctx, "window", "acc_window", args.steps)
    with open_run(cfg, ctx.datasets(cfg), None, ctx.device) as run:
        start, n_steps = run.state.step, run.task.n_steps
        print(f"resumed at step {start}, extending to {n_steps}", flush=True)
        if start == 0:
            raise RuntimeError(f"no checkpoint of acc_window under "
                               f"{ctx.output_dir}: nothing to extend")
        curve = [m for m in prev["train_window"] if m["step"] < start]
        t0 = time.perf_counter()

        def flush_json():
            doc = dict(prev)
            doc["train_window"] = curve
            json_in.write_text(json.dumps(doc))

        for i in range(start, n_steps):
            metrics = run.step(run.next_args(), i)
            if i % acc.CURVE_EVERY == 0:
                loss = float(metrics["loss/loss"])
                curve.append({"step": i, "loss/loss": round(loss, 4)})
                print(f"[window] step {i}: loss {loss:.4f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if i % SAVE_EVERY == 0 and i > start:
                run.save()
                flush_json()
        run.save()
        flush_json()
        sweep = [run.evaluate() for _ in range(acc.FINAL_BATCHES[preset])]

    prev["train_window"] = curve
    prev["final_val"] = {k: float(np.mean([a[k] for a in sweep]))
                         for k in sweep[0]}
    prev["final_val_std"] = {k: float(np.std([a[k] for a in sweep]))
                             for k in sweep[0]}
    prev["final_val_step"] = n_steps
    prev["n_val_events"] = len(sweep) * acc.BATCH
    json_in.write_text(json.dumps(prev))
    write_md(out, prev, n_steps, json_in.name)
    print("wrote", out, flush=True)
    return prev


def write_md(path: Path, doc: Dict, n_steps: int,
             json_name: str = "ACCURACY_torch_dune3d.json") -> None:
    """The extended run's report: the JAX ``acc_extend.write_md``'s table
    (± and σ from the spread across batches), curve, smoothed curve, tail
    slope, backend table and resume line, and the binomial z of each head
    against chance where the doc counts its val events."""
    chance = acc.CHANCE
    final_w, std_w = doc["final_val"], doc["final_val_std"]
    tr_w = doc["train_window"]
    device = doc.get("device") or {}
    lines = [
        "# Accuracy evidence of the PyTorch port — extended run",
        "",
        f"The sparse classifier trained {n_steps} steps, resumed from its",
        "newest checkpoint with the schedule derived over the whole horizon",
        "(sparseeventid_tpu_torch/scripts/acc_extend.py).",
        f"Card: {device.get('nvidia_smi') or device.get('name', 'not recorded')}.",
        "Chance levels: neut/prot 33.3%, cpi/npi 50%.",
        "",
        "## Final val accuracy (mean ± std over the val batches)",
        "",
        "| head | accuracy | chance |",
        "|---|---|---|",
    ]
    for k in sorted(chance):
        sigma = (final_w[k] - chance[k]) / max(std_w[k], 1e-9)
        claim = f"{sigma:+.1f}σ vs chance"
        lines.append(
            f"| {k} | {final_w[k]*100:.1f}% ± {std_w[k]*100:.1f}% "
            f"| {chance[k]*100:.1f}% ({claim}) |"
        )
    lines += [
        f"| loss | {final_w['loss/loss']:.4f} ± {std_w['loss/loss']:.4f}"
        " | — |",
        "",
    ]
    n = doc.get("n_val_events")
    if n:
        lines += [f"Binomial z against chance over the {n} val events swept:"]
        lines += [f"{k} {acc.z_vs_chance(final_w[k], chance[k], n):+.1f}σ"
                  for k in sorted(chance)]
        lines += [""]
    lines += [
        "## Loss curve (train, every 25 steps)",
        "",
        "```",
    ]
    for m in tr_w[:: max(1, len(tr_w) // 24)]:
        lines.append(f"step {m['step']:5d}  loss {m['loss/loss']:.4f}")
    lines += ["```", ""]
    sm = acc.smoothed(tr_w)
    lines += ["## Smoothed loss (250-step moving average)", "", "```"]
    for s, v in sm[:: max(1, len(sm) // 24)]:
        lines.append(f"step {s:5d}  loss {v:.4f}")
    lines += ["```", ""]
    # tail-flatness: mean slope of the last 1000 smoothed steps
    steps_ = [m["step"] for m in tr_w]
    tail = [(s, v) for s, v in sm if s >= steps_[-1] - 1000]
    if len(tail) >= 2:
        slope = (tail[-1][1] - tail[0][1]) / (tail[-1][0] - tail[0][0])
        lines += [
            f"Tail slope (last 1000 steps, smoothed): {slope*1000:+.4f} "
            "loss/1000 steps.",
            "",
        ]
    tr_x, w_short = doc.get("compare_xla", []), doc.get("compare_window", [])
    if tr_x:
        lines += [
            "## Backend equivalence (window vs xla rulebook)",
            "",
            "| step | window loss | xla loss |",
            "|---|---|---|",
        ]
        for mw, mx in zip(w_short, tr_x):
            lines.append(
                f"| {mw['step']} | {mw['loss/loss']:.4f} "
                f"| {mx['loss/loss']:.4f} |"
            )
        dloss = [
            abs(mw["loss/loss"] - mx["loss/loss"])
            for mw, mx in zip(w_short, tr_x)
        ]
        lines += [
            "",
            f"max |window - xla| loss over {len(dloss)} sampled steps: "
            f"{max(dloss):.4f}; mean {np.mean(dloss):.4f}",
        ]
    resume = doc.get("resume", [-1, -1])
    lines += [
        "",
        "## Checkpoint-resume",
        "",
        (
            f"A run torn down and rebuilt auto-resumed at step {resume[0]} "
            f"and continued to {resume[1]}; this run resumed from its "
            "newest checkpoint and saved every 500 steps."
            if resume[0] >= 0
            else "No resume check in this document."
        ),
        "",
        f"Raw curves: see {json_name}.",
    ]
    path.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
