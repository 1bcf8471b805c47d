#!/usr/bin/env python3
"""Time the train loop with its prefetching BatchLoader against a synchronous
fetch, in turns in one process, on one NVIDIA card.

    python3 prefetch_ab.py [--rounds N]

For dune3d and dune2d at chip_smoke.py's full width (B=8, bf16, 16
pre-made synthetic events at the kernel phase's occupancy), each round runs
``train/trainer.train`` for 12 steps twice, once with the loader's
background thread and once with a loader that reads each batch when it is
asked for (the order alternates between rounds), each in a fresh output
directory.  Prints one JSON line a recipe and loader: the median ms of a
step (``StepTimer`` io + step, the first two steps left out) and its io
part, a round each.  With pre-made batches the thread has nothing to hide:
this measures what it costs the loop.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


class SyncLoader:
    """The loader's interface without a thread: serial batches on demand."""

    def __init__(self, cfg, dataset, transform=None):
        self.dataset, self.bs, self.cursor = dataset, cfg.run.minibatch_size, 0
        self.transform = transform

    def __len__(self):
        return max(len(self.dataset) // self.bs, 1)

    def __next__(self):
        n = len(self.dataset)
        idx = [(self.cursor + k) % n for k in range(self.bs)]
        self.cursor = (self.cursor + self.bs) % n
        batch = self.dataset.batch(idx)
        return self.transform(batch) if self.transform is not None else batch

    def stop(self):
        pass


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefetch_ab: no CUDA device", file=sys.stderr)
        return 2
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 5
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from sparseeventid_tpu_torch.train import trainer

    cs.N_BATCHES = 2
    cs.phase_device()
    cs.phase_build()
    loaders = {"thread": trainer.make_loader, "sync": SyncLoader}
    with tempfile.TemporaryDirectory(prefix="prefetch_ab_") as tmp:
        for recipe, make in (("dune3d", cs.make_dataset),
                             ("dune2d", cs.make_dataset_2d)):
            dataset = make()
            rows = {name: [] for name in loaders}
            for r in range(rounds):
                for name in (("thread", "sync") if r % 2 == 0 else ("sync", "thread")):
                    cs.RUN_DIR = Path(tmp) / f"{recipe}_{name}_{r}"
                    cfg = cs.train_config(["run.precision=bfloat16",
                                           "mode.iterations=12"], recipe)
                    trainer.make_loader = loaders[name]
                    try:
                        history = trainer.train(cfg, dataset=dataset,
                                                device="cuda").history[2:]
                    finally:
                        trainer.make_loader = loaders["thread"]
                    rows[name].append((
                        float(np.median([m["time/io_s"] + m["time/step_s"]
                                         for m in history])) * 1e3,
                        float(np.median([m["time/io_s"] for m in history])) * 1e3))
            for name, per_round in rows.items():
                print(json.dumps({"recipe": recipe, "loader": name,
                                  "step_ms": [a for a, _ in per_round],
                                  "io_ms": [b for _, b in per_round]}), flush=True)
            del dataset
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
