"""The fp32 gradient gap of the window kernels on a trained network: one
train step's parameter gradients of a convergence-run model (the
``accuracy_run`` preset's config at float32, dropout off, train mode) on
one fixed batch, the window kernels on host plans against the plain
rulebook backend (``xla``), from the seeded initial weights and from a
checkpoint.

    python -m sparseeventid_tpu_torch.scripts.grad_gap
        [--checkpoint FILE] [--preset small|dune3d] [--events 8]
        [--output-dir DIR] [--device cuda|cpu]

The batch is the first ``--events`` events of the val split.  For each
parameter tensor (the conv biases ahead of a batch norm left out: their
true gradient is 0 and both sides return rounding noise) it gives
||g_window - g_xla||_2 / ||g_xla||_2 (``rel_l2``; ``chip_smoke.py``'s
fp32_grad_compare takes its gradients and ratios from here too), and prints one JSON line a set of weights ("init",
"trained"): the loss of each side, the largest ratio and its tensor, the
median, and every tensor's ratio.  TF32 is off.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from ..models import build_model, init_parameters
from ..train.evaluate import build_dataset, prepare_batch
from ..train.losses import multi_head_loss
from ..train.plans import run_planner
from ..utils.checkpoint import load_checkpoint
from . import accuracy_run as acc

FP32 = ("run.precision=float32", "head.dropout=0.0")


def step_gradients(model, cfg, batch, grid, dev: torch.device,
                   planner=None, backward=torch.Tensor.backward):
    """-> (loss, dropped pairs, {name: gradient}) of one train-mode step of
    ``model`` (on ``dev``) on ``batch``, on ``planner``'s host plans where
    one is given; ``backward(loss)`` runs the backward."""
    model.zero_grad(set_to_none=True)
    st, labels = prepare_batch(batch, grid, model.encoder.capacities[0],
                               torch.float32, dev)
    plans = (planner.plans(st, planner.to_device(planner.build(batch["image"]),
                                                 dev))
             if planner is not None else None)
    logits, dropped = model(st, plans=plans)
    loss, _ = multi_head_loss(logits, labels,
                              cfg.mode.optimizer.loss_balance_scheme)
    backward(loss)
    return float(loss.detach()), int(dropped), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}


def rel_l2(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
           ) -> Dict[str, float]:
    """||got - ref||_2 / ||ref||_2 for each tensor of ``ref``, the conv
    biases ahead of a batch norm (".b") left out."""
    return {n: float((got[n] - ref[n]).norm() / ref[n].norm())
            for n in ref if not n.endswith(".b")}


def gradients(cfg, state: Dict[str, torch.Tensor] | None, batch, grid,
              dev: torch.device):
    """-> (loss, {name: gradient}) of one train-mode step of ``cfg``'s model
    from ``state`` (None: the seeded initialisation)."""
    model, _ = build_model(cfg)
    if state is None:
        init_parameters(model, cfg.run.seed)
    else:
        model.load_state_dict(state)
    model.to(dev).train()
    loss, dropped, grads = step_gradients(model, cfg, batch, grid, dev,
                                          run_planner(cfg, grid))
    if dropped != 0:
        raise RuntimeError(f"{dropped} pairs dropped")
    return loss, grads


def gap(ctx, state, batch, grid) -> Dict:
    cfgs = {b: acc.preset_config(ctx, b, "grad_gap", 1, extra=FP32)
            for b in ("xla", "window")}
    ref_loss, ref = gradients(cfgs["xla"], state, batch, grid, ctx.device)
    loss, got = gradients(cfgs["window"], state, batch, grid, ctx.device)
    rel = rel_l2(got, {n: g for n, g in ref.items() if float(g.norm()) > 0})
    worst = max(rel, key=rel.get)
    return {"xla_loss": ref_loss, "window_loss": loss, "tensors": len(rel),
            "worst_rel_l2": rel[worst], "worst_tensor": worst,
            "median_rel_l2": float(np.median(list(rel.values()))),
            "rel_l2": rel}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the preset's model (step_<n>.pt)")
    p.add_argument("--events", type=int, default=acc.BATCH)
    acc.add_preset_args(p)
    args = p.parse_args(argv)
    ctx = acc.open_context(args.preset, args.device,
                           args.output_dir or acc.OUTPUT_DIR / args.preset)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = acc.preset_config(ctx, "xla", "grad_gap", 1, extra=FP32)
    datasets = ctx.datasets(cfg)
    val = datasets["val"] if datasets else build_dataset(cfg, "val")
    batch = val.batch(list(range(args.events)))
    grid = tuple(val.batch_grid())
    out = {"device": acc.device_fields(ctx.device), "events": args.events}
    weights = {"init": None}
    if args.checkpoint:
        weights["trained"] = load_checkpoint(args.checkpoint, ctx.device)["model"]
    for what, state in weights.items():
        out[what] = gap(ctx, state, batch, grid)
        print(json.dumps({"weights": what, **out[what]}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
