"""Detector preprocessing, raw simulation file -> labelled sparse 2D
multiplane training file: the port of ``scripts/preprocess_fullres_2d.py``,
constant for constant (the reference's ``preprocess_fullres_2D.cfg``):

  * Threshold           value > 0.01, per plane
  * EmptyTensorFilter   at least 25 voxels left over the planes
  * CompressAndEmbed    each plane embedded, centred, in 2048 rows x 1280
                        columns with compression 1: the voxel ids are
                        linearized again from the input grid into the
                        output grid
  * EventPIDLabel       the 3D tool's thresholds (``preprocess_fullres_3d``)
  * TensorFromCluster2D the raw file's linear voxel ids pass through

Input: ``Data/sparse2d_<producer>_group`` (one projection per wire plane)
and ``Data/particle_<particle-producer>_group`` with every particle of an
event.  Output: the training layout of ``io/larcv.py``'s ``LarcvWriter``
(3 projections).  Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.preprocess_fullres_2d \
        raw.h5 out.h5 [--producer sbndvoxels] [--particle-producer sbndseg] \
        [--input-rows 2048] [--input-cols 1280]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..io.larcv import LarcvWriter, read_raw_events
from .preprocess_fullres_3d import write_labelled

THRESHOLD = 0.01
MIN_VOXEL_COUNT = 25
OUT_ROWS = 2048
OUT_COLS = 1280
N_PLANES = 3


def embed_ids(ids: np.ndarray, in_rows: int, in_cols: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """CompressAndEmbed with compression 1: voxel ids of the (in_rows,
    in_cols) grid -> ids of the centred (OUT_ROWS, OUT_COLS) grid, and
    which of them land inside it."""
    row = (ids // in_cols).astype(np.int64)
    col = (ids % in_cols).astype(np.int64)
    row = row + (OUT_ROWS - in_rows) // 2
    col = col + (OUT_COLS - in_cols) // 2
    ok = (row >= 0) & (row < OUT_ROWS) & (col >= 0) & (col < OUT_COLS)
    return (row * OUT_COLS + col).astype(np.uint64), ok


def preprocess(src, dst, producer: str = "sbndvoxels",
               particle_producer: str = "sbndseg", input_rows: int = OUT_ROWS,
               input_cols: int = OUT_COLS) -> dict:
    raw = read_raw_events(src, "sparse2d", producer, particle_producer)
    writer = LarcvWriter(dst, producer, n_projections=N_PLANES,
                         meta=dict(n_voxels=[N_PLANES, OUT_ROWS, OUT_COLS]),
                         dimension=2)
    kept = dropped_empty = 0
    for ev in range(len(raw)):
        planes, total = [], 0
        for p in range(min(int(raw.extents[ev]["n"]), N_PLANES)):
            vv = raw.projection(ev, p)
            keep = vv["value"] > THRESHOLD
            ids, ok = embed_ids(vv["id"][keep], input_rows, input_cols)
            planes.append((ids[ok], vv["value"][keep][ok].astype(np.float32)))
            total += int(ok.sum())
        while len(planes) < N_PLANES:
            planes.append((np.zeros(0, np.uint64), np.zeros(0, np.float32)))
        if total < MIN_VOXEL_COUNT:
            dropped_empty += 1
            continue
        write_labelled(writer, planes, raw.event_particles(ev))
        kept += 1
    writer.close()
    return dict(kept=kept, dropped_empty=dropped_empty, output=str(dst))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--producer", default="sbndvoxels")
    ap.add_argument("--particle-producer", default="sbndseg")
    ap.add_argument("--input-rows", type=int, default=OUT_ROWS)
    ap.add_argument("--input-cols", type=int, default=OUT_COLS)
    args = ap.parse_args(argv)
    print(json.dumps(preprocess(args.input, args.output, args.producer,
                                args.particle_producer, args.input_rows,
                                args.input_cols)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
