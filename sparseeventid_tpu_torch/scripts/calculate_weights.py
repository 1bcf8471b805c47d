"""Per-label class frequencies and weights of a larcv file: the port of
``scripts/calculate_weights.py`` (the counts of each label producer's pdg
values, and total / (classes x count) as each class's weight), with the
same printed lines.  Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.calculate_weights file.h5 \
        [--image-key dunevoxels]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.larcv import LarcvDataset


def class_weights(path, image_key: str = "dunevoxels") -> list:
    """-> the printed lines: a group line per label producer, then one line
    per class."""
    ds = LarcvDataset(path, image_key, normalize=False, native=False)
    lines = []
    for key, arr in ds.labels.items():
        labels, counts = np.unique(arr, return_counts=True)
        lines.append(f"Group {key}")
        total = counts.sum()
        for lb, ct in zip(labels, counts):
            w = total / (len(labels) * ct)
            lines.append(f"    label = {lb}, events = {ct}, weight = {w:.4f}")
    ds.close()
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("file")
    p.add_argument("--image-key", default="dunevoxels")
    args = p.parse_args(argv)
    for line in class_weights(args.file, args.image_key):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
