"""A dune3d-occupancy synthetic larcv file for end-to-end throughput runs:
the port of ``scripts/make_dune3d_file.py``, with its arguments and seed.
About 25k active voxels an event on the full 1024 x 512 x 1280 grid, 512
events by default.  Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.make_dune3d_file \
        [out.h5 (default: dune3d_synth.h5 in the temporary directory)] \
        [n_events (default: 512)]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from ..io.larcv import write_synthetic_larcv_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = (argv[0] if argv
           else os.path.join(tempfile.gettempdir(), "dune3d_synth.h5"))
    n = int(argv[1]) if len(argv) > 1 else 512
    t0 = time.time()
    write_synthetic_larcv_file(
        out, n_events=n, image_size=(1024, 512, 1280), seed=1234,
        mean_tracks=40.0, steps_per_track=900, max_voxels=50000,
    )
    print(f"wrote {n} events to {out} in {time.time() - t0:.1f}s, "
          f"{os.path.getsize(out) / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
