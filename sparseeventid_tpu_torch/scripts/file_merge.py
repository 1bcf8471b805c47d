"""larcv files merged into a train and a test split: the port of
``scripts/file_merge.py``.  The events of all inputs are shuffled with
``np.random.default_rng(seed)`` and the first ``--train-fraction`` (0.8)
of them written to ``out_dir/train.h5``, the rest to ``out_dir/test.h5``.
Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.file_merge out_dir \
        in1.h5 in2.h5 ... [--image-key dunevoxels] [--dimension 3] \
        [--train-fraction 0.8] [--seed 0]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..io.larcv import LarcvWriter
from .file_premerge import copy_event, open_files


def merge(out_dir, inputs, image_key: str = "dunevoxels", dimension: int = 3,
          train_fraction: float = 0.8, seed: int = 0) -> dict:
    """-> {split: (events, path)}."""
    datasets = open_files(inputs, image_key, dimension)
    events = [(d_i, e_i) for d_i, d in enumerate(datasets)
              for e_i in range(len(d))]
    rng = np.random.default_rng(seed)
    rng.shuffle(events)
    n_train = int(len(events) * train_fraction)
    splits = {"train": events[:n_train], "test": events[n_train:]}

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    for split, evs in splits.items():
        path = out_dir / f"{split}.h5"
        writer = LarcvWriter(path, image_key, datasets[0].n_projections,
                             datasets[0].meta, dimension=dimension)
        for d_i, e_i in evs:
            copy_event(datasets[d_i], e_i, writer)
        writer.close()
        print(f"{split}: {len(evs)} events -> {path}")
        written[split] = (len(evs), path)
    for ds in datasets:
        ds.close()
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--image-key", default="dunevoxels")
    p.add_argument("--dimension", type=int, default=3)
    p.add_argument("--train-fraction", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    merge(args.out_dir, args.inputs, args.image_key, args.dimension,
          args.train_fraction, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
