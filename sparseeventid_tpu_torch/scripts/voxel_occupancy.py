"""Active-voxel occupancy of a larcv file: the port of
``scripts/voxel_occupancy.py`` (mean, spread, largest and 99th-percentile
voxel count of each plane, and the capacity that holds 99.5% of the
events, rounded up to 1024), with the same printed lines.  It sizes the
static capacity schedule.  Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.voxel_occupancy file.h5 \
        [--image-key dunevoxels] [--dimension 3]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io.larcv import LarcvDataset


def occupancy(path, image_key: str = "dunevoxels", dimension: int = 3) -> list:
    """-> the printed lines."""
    ds = LarcvDataset(path, image_key, dimension=dimension, normalize=False,
                      max_voxels=10**9, native=False)
    counts = np.zeros((len(ds), ds.n_projections))
    for i in range(len(ds)):
        for pi, (ids, _) in enumerate(ds._event_voxels(i)):
            counts[i, pi] = len(ids)
    ds.close()
    lines = ["Average voxel occupation:"]
    for pi in range(counts.shape[1]):
        c = counts[:, pi]
        lines.append(f"  plane {pi}: {c.mean():.2f} +/- {c.std():.2f} "
                     f"({int(c.max())} max, p99 {np.percentile(c, 99):.0f})")
    capacity = int(-(-np.percentile(counts.sum(axis=1), 99.5) // 1024) * 1024)
    lines.append(f"suggested capacity (p99.5 rounded up to 1024): {capacity}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("file")
    p.add_argument("--image-key", default="dunevoxels")
    p.add_argument("--dimension", type=int, default=3)
    args = p.parse_args(argv)
    for line in occupancy(args.file, args.image_key, args.dimension):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
