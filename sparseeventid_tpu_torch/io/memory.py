"""The events of a synthetic larcv file without the file: for hosts that
have no h5py and no libhdf5, where a larcv file can be neither written nor
read.

``synthetic_larcv_dataset(spec, ...)`` generates every event of
``write_synthetic_larcv_file(path, **spec)`` at construction, as the
writer would (``larcv.synthetic_larcv_event``: event i from
``np.random.default_rng((seed, i))``), and hands them to
``LarcvDataset.from_events``: its ``batch(indices)`` is the batch of that
file read with the same ``max_voxels`` and ``normalize`` (coordinates and
values, the four labels, energy, vertex and ``index``, for 3D data and for
2D planes).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np

from .larcv import (
    LABEL_PRODUCERS,
    LarcvDataset,
    synthetic_larcv_event,
    synthetic_larcv_grid,
    write_synthetic_larcv_file,
)


@dataclasses.dataclass(frozen=True)
class SyntheticFileSpec:
    """The arguments of ``write_synthetic_larcv_file`` but the path."""

    n_events: int
    image_size: Tuple[int, ...]
    seed: int = 0
    dimension: int = 3
    mean_tracks: float = 3.0
    steps_per_track: int = 200
    max_voxels: int = 2048
    planes: bool = False

    def file_name(self, stem: str) -> str:
        """``<stem>_<digest of the spec>.h5``: a file of other settings
        never stands in for this one."""
        return f"{stem}_{zlib.crc32(repr(self).encode()):08x}.h5"

    def write(self, path):
        return write_synthetic_larcv_file(path, **dataclasses.asdict(self))


def synthetic_larcv_dataset(spec: SyntheticFileSpec, max_voxels: int = 50000,
                            normalize: bool = True,
                            native: bool = True) -> LarcvDataset:
    """``LarcvDataset`` over the events of ``write_synthetic_larcv_file(
    **spec)``, generated in memory (no file, no h5py)."""
    events = []
    labels = {f"label{k}": [] for k in LABEL_PRODUCERS}
    energy, vertex = [], []
    for i in range(spec.n_events):
        projections, labs, aux = synthetic_larcv_event(
            i, spec.image_size, spec.seed, spec.mean_tracks,
            spec.steps_per_track, spec.max_voxels, spec.planes)
        events.append(projections)
        for key in labels:
            labels[key].append(labs[key])
        # the file's particle rows: energy_deposit f8, vertex f8[3]
        energy.append(float(aux["energy"]))
        vertex.append(np.asarray(aux["vertex"], np.float64))
    return LarcvDataset.from_events(
        events, synthetic_larcv_grid(spec.image_size, spec.planes),
        spec.dimension,
        labels={k: np.asarray(v, np.int32) for k, v in labels.items()},
        energy=np.asarray(energy, np.float64),
        vertex=np.stack(vertex).astype(np.float32) if vertex else None,
        max_voxels=max_voxels, normalize=normalize, native=native,
        name=f"memory:{spec}")
