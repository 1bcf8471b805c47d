"""larcv files merged in fixed-size chunks: the port of
``scripts/file_premerge.py``.  Chunks of ``--chunk-size`` files (8, as the
reference's merge of larcv files) are written to
``<out_prefix>_chunk<size>_<i>.h5``; events keep their file order (no
shuffle and no split: that is ``file_merge``'s work).  Host work: it
needs h5py, so it runs on a host that has it (its tests hold it against
the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.file_premerge out_prefix \
        in1.h5 in2.h5 ... [--chunk-size 8] [--image-key dunevoxels] \
        [--dimension 3]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..io.larcv import LarcvDataset, LarcvWriter


def open_files(paths, image_key: str, dimension: int) -> list:
    """Readers of whole events: raw values, no voxel cap."""
    return [LarcvDataset(p, image_key, dimension=dimension, normalize=False,
                         max_voxels=10**9, native=False) for p in paths]


def copy_event(ds: LarcvDataset, e_i: int, writer: LarcvWriter) -> None:
    """Event ``e_i`` of ``ds`` into ``writer``: its projections, labels and
    energy."""
    projections = [(ids.astype(np.uint64), vals)
                   for ids, vals in ds._event_voxels(e_i)]
    labels = {k: int(v[e_i]) for k, v in ds.labels.items()}
    energy = float(ds.energy[e_i]) if ds.energy is not None else 0.0
    writer.write_event(projections, labels=labels or None, energy=energy)


def premerge(inputs, out_prefix, chunk_size: int = 8,
             image_key: str = "dunevoxels", dimension: int = 3) -> list:
    written = []
    for i in range(0, len(inputs), chunk_size):
        chunk = inputs[i:i + chunk_size]
        out = Path(f"{out_prefix}_chunk{chunk_size}_{i // chunk_size}.h5")
        print(f"Merging {len(chunk)} files from {i} to {i + len(chunk)}"
              f" -> {out}")
        datasets = open_files(chunk, image_key, dimension)
        writer = LarcvWriter(out, image_key, datasets[0].n_projections,
                             datasets[0].meta, dimension=dimension)
        for ds in datasets:
            for e_i in range(len(ds)):
                copy_event(ds, e_i, writer)
            ds.close()
        writer.close()
        written.append(out)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_prefix")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--chunk-size", type=int, default=8)
    p.add_argument("--image-key", default="dunevoxels")
    p.add_argument("--dimension", type=int, default=3)
    args = p.parse_args(argv)
    premerge(args.inputs, args.out_prefix, args.chunk_size, args.image_key,
             args.dimension)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
