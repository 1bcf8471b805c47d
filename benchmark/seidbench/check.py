"""The numbers that decide ``correct``: the program's first steps against
the reference's, each beside its limit.

- ``input_mismatch``: sites (batch, coordinates) and labels of the three
  prepared batches that differ from the ones the reference derives from
  the raw events; exact, limit 0.
- ``input_gap``: the largest charge difference over the largest charge.
- ``loss_gap``: the largest |loss - reference| / |reference| of the steps.
- ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - b1), by the median parameter: of each
  parameter |norm - reference norm| over the larger of the reference's
  norm and the median parameter's, the median.  (The worst parameter is
  a batch-norm scale at level 0 or 1 whose gradient, a cancelling sum
  over the batch's sites, carries 5-20% of bf16 rounding on any seed, so
  it cannot tell a fault from rounding.)
- ``conv_grad_gap``: the same first gradient by the worst of the model
  family's ``gradient_leaves`` (the sparse ResNet's: its conv weights,
  the encoder's ``*_w`` and ``*.w``, batch-norm scales not among them):
  a backward fault confined to one conv's dW moves no median, and AdamW's
  change hides its scale.
- ``update_gap``: each parameter's change over the steps, by the worst
  parameter.
- ``dropped``: conv pairs and sites the program lost to its static
  capacities in the checked steps and the window; exact, limit 0.
- ``failed_steps``: window steps whose loss is not finite; limit 0.

Parameters whose reference gradient is under a thousandth of the median
parameter's (the conv biases in front of a batch norm, whose gradient is
nought to rounding) are left out of ``grad_gap`` and ``update_gap``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

ORDER = ("input_mismatch", "input_gap", "loss_gap", "grad_gap",
         "conv_grad_gap", "update_gap", "dropped", "failed_steps")
LEFT_OUT_BELOW = 1e-3


def counted(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= LEFT_OUT_BELOW * med]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: Sequence[str]) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names: Sequence[str]) -> float:
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med)
                             for n in names)


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 names: Sequence[str], k: int = 4):
    """The ``k`` parameters of the largest gap: (name, gap, program's norm,
    reference's norm)."""
    med = statistics.median(ref[n] for n in names)
    rows = [(n, abs(prog[n] - ref[n]) / max(ref[n], med), prog[n], ref[n])
            for n in names]
    return sorted(rows, key=lambda r: -r[1])[:k]


def input_numbers(prog_inputs, ref_inputs, prog_labels, ref_labels):
    """-> (mismatched sites and labels, largest charge gap over the largest
    charge).  Inputs: per batch (batch index i64[n], coords i64[n, 3],
    charge f32[n]) in the family's canonical order."""
    mismatch, gap = 0, 0.0
    for (pb, pc, pv), (rb, rc, rv) in zip(prog_inputs, ref_inputs):
        pb, pc, pv = (t.cpu() for t in (pb, pc, pv))
        rb, rc, rv = (t.cpu() for t in (rb, rc, rv))
        if len(pb) != len(rb):
            mismatch += abs(len(pb) - len(rb)) + min(len(pb), len(rb))
            gap = math.inf
            continue
        differ = (pb != rb) | torch.any(pc != rc, dim=1)
        mismatch += int(differ.sum())
        scale = float(rv.abs().max()) if len(rv) else 1.0
        if len(rv):
            gap = max(gap, float((pv.float() - rv).abs().max()) / scale)
    for pl, rl in zip(prog_labels, ref_labels):
        for key, r in rl.items():
            mismatch += int((torch.as_tensor(pl[key]).cpu().long()
                             != torch.as_tensor(r).long()).sum())
    return mismatch, gap


def numbers(prog, ref, prog_labels, ref_labels, dropped: int,
            failed_steps: int, model) -> Dict[str, float]:
    """The program's ``reference.Readings``-shaped record against the
    reference's; ``model`` is the cell's model family."""
    names = counted(ref.grad_norms)
    mismatch, in_gap = input_numbers(prog.inputs, ref.inputs, prog_labels,
                                     ref_labels)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses))
    if not all(math.isfinite(x) for x in prog.losses):
        loss_gap = math.inf
    return {
        "input_mismatch": mismatch,
        "input_gap": in_gap,
        "loss_gap": loss_gap,
        "grad_gap": median_leaf(prog.grad_norms, ref.grad_norms, names),
        "conv_grad_gap": worst_leaf(prog.grad_norms, ref.grad_norms,
                                    model.gradient_leaves(names)),
        "update_gap": worst_leaf(prog.change_norms, ref.change_norms, names),
        "dropped": dropped,
        "failed_steps": failed_steps,
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit", "ok"}}) in ``ORDER``; a
    number with no limit fails."""
    out, ok = {}, True
    for name in ORDER:
        v, lim = values.get(name), limits.get(name)
        good = (v is not None and lim is not None and math.isfinite(v)
                and v <= lim)
        ok &= good
        out[name] = {"value": v, "limit": lim, "ok": good}
    return ok, out


def lines(checks: Dict[str, Dict]) -> List[str]:
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in checks.items()]

