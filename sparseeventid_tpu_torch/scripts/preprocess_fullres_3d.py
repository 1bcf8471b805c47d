"""Detector preprocessing, raw simulation file -> labelled sparse 3D
training file: the port of ``scripts/preprocess_fullres_3d.py``, constant
for constant (the larcv3 ProcessDriver chain of the reference's
``preprocess_fullres_3D.cfg``):

  * Threshold           value > 0.1
  * EmptyTensorFilter   at least 50 voxels left
  * EventPIDLabel       proton 20 MeV / charged pion 10 MeV / neutral pion
                        0 MeV energy thresholds -> neutID / protID / cpiID /
                        npiID, one label particle each per event
  * TensorFromCluster3D the raw file's linear voxel ids pass through

Input: ``Data/sparse3d_<producer>_group`` voxels and
``Data/particle_<particle-producer>_group`` with every particle of an event
(pdg, energy_deposit).  Output: the training layout of ``io/larcv.py``'s
``LarcvWriter``.  Host work: it needs h5py, so it runs on
a host that has it (its tests hold it against the JAX script there).

    python -m sparseeventid_tpu_torch.scripts.preprocess_fullres_3d \
        raw.h5 out.h5 [--producer sbndvoxels] [--particle-producer sbndseg]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..io.larcv import LarcvWriter, read_raw_events

THRESHOLD = 0.1
MIN_VOXEL_COUNT = 50
PROTON_THRESHOLD = 0.020  # GeV
CPI_THRESHOLD = 0.010
NPI_THRESHOLD = 0.000

# the dune3d detector's meta
META = dict(
    n_voxels=[1024, 512, 1280],
    size=[409.6, 204.8, 516.0],
    origin=[0.0, -100.0, 0.0],
)


def event_pid_labels(pdg: np.ndarray, edep: np.ndarray) -> dict:
    """EventPIDLabel: the event's labels from its particle list.

    neutID: 0 = nu_e CC (an electron deposits), 1 = nu_mu CC (a muon
    deposits), 2 = NC.  protID: protons above threshold, at most 2.
    cpiID / npiID: a charged / neutral pion above threshold."""
    apdg = np.abs(pdg)
    if np.any((apdg == 11) & (edep > 0)):
        neut = 0
    elif np.any((apdg == 13) & (edep > 0)):
        neut = 1
    else:
        neut = 2
    prot = int(min(np.sum((pdg == 2212) & (edep > PROTON_THRESHOLD)), 2))
    cpi = int(np.any((apdg == 211) & (edep > CPI_THRESHOLD)))
    npi = int(np.any((pdg == 111) & (edep > NPI_THRESHOLD)))
    return {
        "labelneutID": neut,
        "labelprotID": prot,
        "labelcpiID": cpi,
        "labelnpiID": npi,
    }


def write_labelled(writer: LarcvWriter, projections, particles) -> None:
    """One kept event: its projections, its labels and its total energy."""
    writer.write_event(
        projections,
        labels=event_pid_labels(particles["pdg"].astype(np.int64),
                                particles["energy_deposit"]),
        energy=float(particles["energy_deposit"].sum()),
    )


def preprocess(src, dst, producer: str = "sbndvoxels",
               particle_producer: str = "sbndseg") -> dict:
    raw = read_raw_events(src, "sparse3d", producer, particle_producer)
    writer = LarcvWriter(dst, producer, n_projections=1, meta=META,
                         dimension=3)
    kept = dropped_empty = 0
    for ev in range(len(raw)):
        ids_list, val_list = [], []
        for p in range(int(raw.extents[ev]["n"])):
            vv = raw.projection(ev, p)
            keep = vv["value"] > THRESHOLD
            ids_list.append(vv["id"][keep])
            val_list.append(vv["value"][keep])
        ids = np.concatenate(ids_list) if ids_list else np.zeros(0, np.uint64)
        vals = (np.concatenate(val_list) if val_list
                else np.zeros(0, np.float32))
        if len(ids) < MIN_VOXEL_COUNT:
            dropped_empty += 1
            continue
        write_labelled(writer,
                       [(ids.astype(np.uint64), vals.astype(np.float32))],
                       raw.event_particles(ev))
        kept += 1
    writer.close()
    return dict(kept=kept, dropped_empty=dropped_empty, output=str(dst))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--producer", default="sbndvoxels")
    ap.add_argument("--particle-producer", default="sbndseg")
    args = ap.parse_args(argv)
    print(json.dumps(preprocess(args.input, args.output, args.producer,
                                args.particle_producer)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
