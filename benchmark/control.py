"""The readings that the limits of a cell's correctness numbers are set
from, at the cell's own size, one seed after another in one process:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--program]

For each seed, one JSON line: with ``--program`` the program's numbers
(its first three steps through the session, on the cell's traffic,
against the float32 reference: the lower readings); always the
control's (the reference in float8_e4m3fn in the program's place) and
the planted faults' ("half": the loss over half of each batch; "alter":
one charge doubled where the batch is made) against the float32
reference.  Each is read by ``check.numbers`` and judged by
``check.verdict`` against the cell's limits, as a run judges the
program; ``grad_gap_worst`` (the worst parameter's first gradient) is
printed beside them and judged by none.  A step that leaves its state
unchanged reads 1 on ``update_gap`` by construction.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--precision", default=None,
                   help="run the program at this precision instead of the "
                   "configuration's (a witness: float32)")
    args = p.parse_args(argv)

    import torch

    from seidbench import check, generator, harness, program, reference

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = harness.load_spec(args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    if args.precision is not None:
        cfg = dict(cfg, overrides=[o for o in cfg["overrides"]
                                   if not o.startswith("run.precision=")]
                   + [f"run.precision={args.precision}"])
    batch = int(traffic["batch"])
    epoch = int(traffic["split"]) // batch
    for seed in args.seeds:
        t = time.perf_counter()
        events, labels = generator.make_pool(int(traffic["pool"]), seed,
                                             cfg["generator"])
        split = program.Split(events, labels, int(traffic["split"]), cfg)
        weights = reference.make_weights(cfg["arch"], seed, dev)
        out = {"workload": args.workload, "seed": seed,
               "precision": args.precision or cfg["precision"]}
        prog = None
        if args.program:
            pcfg = program.program_config(cfg, traffic, spec["name"], seed,
                                          spec["work_dir"] / "control", dev)
            with program.open_session(pcfg, split, weights, dev,
                                      bool(traffic.get("fill_cache"))) as run:
                prog, prog_labels, dropped = program.checked_steps(
                    run, harness.CHECKED_STEPS, weights,
                    float(cfg["optimizer"]["b1"]))
                del run
            rows = [split.events_of(k) for k in range(harness.CHECKED_STEPS)]
            gc.collect()
            torch.cuda.empty_cache()
        else:  # the pool's first events, in order
            rows = [list(range(k * batch, (k + 1) * batch))
                    for k in range(harness.CHECKED_STEPS)]
        batches = [([events[i] for i in r], {k: v[r] for k, v in labels.items()})
                   for r in rows]
        ref = reference.train_steps(cfg, weights, batches, seed % 2**31,
                                    epoch, dev)
        names = check.counted(ref.grad_norms)
        out["left_out"] = sorted(set(ref.grad_norms) - set(names))

        def judged(values, readings):
            correct, checks = check.verdict(values, spec["limits"])
            return dict(values, correct=correct, failing=[
                n for n, c in checks.items() if not c["ok"]],
                grad_gap_worst=check.worst_leaf(
                    readings.grad_norms, ref.grad_norms, names))

        if prog is not None:
            out["program"] = judged(check.numbers(
                prog, ref, prog_labels,
                [{k: v[r] for k, v in labels.items()} for r in rows],
                dropped, 0), prog)
            out["program_worst"] = {
                "grad": check.worst_leaves(prog.grad_norms, ref.grad_norms,
                                           names),
                "update": check.worst_leaves(prog.change_norms,
                                             ref.change_norms, names)}
        for name, kw in (("control", {"precision": "float8_e4m3fn"}),
                         ("half", {"variant": "half"}),
                         ("alter", {"variant": "alter"})):
            faulty = reference.train_steps(cfg, weights, batches,
                                           seed % 2**31, epoch, dev, **kw)
            out[name] = judged(check.numbers(faulty, ref, [], [], 0, 0),
                               faulty)
        out["losses"] = ref.losses
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        del split, weights
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
