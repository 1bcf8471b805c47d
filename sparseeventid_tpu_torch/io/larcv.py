"""larcv3-schema HDF5 reader + writer (JAX counterpart: ``io/larcv.py``, of
which this is a copy with the native reads and assembly of ``io/hostio.py``)
— replaces the larcv3 C++ IO engine (queue_interface / BatchFillers).

Schema notes (reverse-engineered from the reference's direct h5py usage —
reference src/io/larcv_fetcher.py:307-314 reads
``Data/particle_<producer>_group/particles['energy_deposit']`` and
reference scripts/calculate_weights.py:5-13 reads
``Data/particle_<label>_group/particles['pdg']``):

    Data/
      particle_<producer>_group/
        extents    : compound (first u64, n u32), one row per event
        particles  : compound (id, pdg i32, energy_deposit f64, ...) flat
      sparse3d_<producer>_group/  (sparse2d_* for 2D)
        extents        : compound (first u64, n u32), one row per event,
                         indexing voxel_extents (one row per projection)
        voxel_extents  : compound (first u64, n u32), one row per
                         (event x projection), indexing voxels
        voxels         : compound (id u64, value f32); id = row-major
                         linear voxel index within the projection meta

Label contract (larcv_fetcher.py:145-155,428-431): producers neutID /
protID / cpiID / npiID carry exactly one particle per event whose ``pdg``
field IS the class label; producer ``event`` carries the true particle with
``energy_deposit``.

The writer emits the same layout (used for golden tests, for converting
detector data, and for inference output writing — the larcv_writer
capability of the legacy stack, torch_inference.py:719-776).

Real-file tolerance (no larcv3 install or real file is reachable in this
environment, so fidelity is contractual, not verified byte-for-byte —
tests/test_larcv_schema.py reads a verbatim-layout fixture built
independently of LarcvWriter):

- The ONLY particle fields the reference itself depends on are ``pdg``
  and ``energy_deposit`` (calculate_weights.py:5-13,
  larcv_fetcher.py:307-314); any extra compound fields (track_id, px/py/
  pz, creation_process, ...) are tolerated and ignored.  Vertex comes
  from a ``vertex`` field (our writer) or real larcv3's separate
  ``vtx_x``/``vtx_y``/``vtx_z`` scalars.
- Particle rows are indexed through the group's ``extents`` (first row
  per event), never by assuming row i == event i.
- Extents field names are matched case-insensitively (``first``/``n``).
- Detector meta need NOT be in the file: the reference hard-codes it per
  detector (larcv_fetcher.py:16-57) and so do we (config DETECTOR_META);
  pass ``image_size=`` to the reader.  A file-side ``meta`` JSON attr
  (our writer) or an ``image_meta`` dataset of JSON strings is parsed
  when present.
- Voxel compound fields are matched by NAME (``id``/``value``) both here
  (h5py) and in the native reader (csrc/hostio.cpp H5Tcreate memtype), so
  on-disk padding/packing differences don't matter.

h5py is imported only inside the functions that open a file, so the package
imports without it.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hostio

logger = logging.getLogger(__name__)

EXTENT_DTYPE = np.dtype([("first", "<u8"), ("n", "<u4")])
VOXEL_DTYPE = np.dtype([("id", "<u8"), ("value", "<f4")])
PARTICLE_DTYPE = np.dtype(
    [
        ("id", "<u8"),
        ("pdg", "<i4"),
        ("energy_deposit", "<f8"),
        ("energy_init", "<f8"),
        ("vertex", "<f8", (3,)),
    ]
)

LABEL_PRODUCERS = ("neutID", "protID", "cpiID", "npiID")


def _extent_fields(dtype) -> Tuple[str, str]:
    """Case-insensitive (first, n) field names of an extents compound."""
    names = {n.lower(): n for n in dtype.names}
    try:
        return names["first"], names["n"]
    except KeyError:
        raise KeyError(
            f"extents dataset has fields {dtype.names}, expected first/n"
        )


def _read_extents(dataset) -> np.ndarray:
    """Extents as a canonical (first u64, n u32) array."""
    raw = dataset[:]
    f, n = _extent_fields(raw.dtype)
    out = np.empty(len(raw), EXTENT_DTYPE)
    out["first"] = raw[f].astype(np.uint64)
    out["n"] = raw[n].astype(np.uint32)
    return out


@dataclass(frozen=True)
class RawEvents:
    """One image group and one particle group of a larcv file, whole: the
    input of the preprocessing tools (``scripts/preprocess_fullres_*``),
    whose particle groups hold every particle of an event."""

    extents: np.ndarray  # (first, n) per event, into voxel_extents
    voxel_extents: np.ndarray  # (first, n) per (event, projection)
    voxels: np.ndarray  # (id, value)
    particle_extents: np.ndarray  # (first, n) per event, into particles
    particles: np.ndarray  # (pdg, energy_deposit, ...)

    def __len__(self) -> int:
        return len(self.extents)

    def projection(self, event: int, p: int) -> np.ndarray:
        """The voxels of projection ``p`` of ``event``."""
        ve = self.voxel_extents[int(self.extents[event]["first"]) + p]
        first = int(ve["first"])
        return self.voxels[first: first + int(ve["n"])]

    def event_particles(self, event: int) -> np.ndarray:
        first, n = (int(v) for v in self.particle_extents[event])
        return self.particles[first: first + n]


def read_raw_events(path: str | Path, datatype: str, image_producer: str,
                    particle_producer: str) -> RawEvents:
    """The ``<datatype>_<image_producer>`` group (``sparse3d`` or
    ``sparse2d``) and the ``particle_<particle_producer>`` group of a file."""
    import h5py

    with h5py.File(path, "r") as f:
        img = f[f"Data/{datatype}_{image_producer}_group"]
        par = f[f"Data/particle_{particle_producer}_group"]
        return RawEvents(_read_extents(img["extents"]),
                         _read_extents(img["voxel_extents"]),
                         img["voxels"][:], _read_extents(par["extents"]),
                         par["particles"][:])


def _particle_vertex(particles: np.ndarray) -> Optional[np.ndarray]:
    """Per-row vertex from a particle compound: our writer's ``vertex``
    triple, or real larcv3's ``vtx_x``/``vtx_y``/``vtx_z`` scalars."""
    names = particles.dtype.names
    if "vertex" in names:
        return particles["vertex"].astype(np.float32)
    if all(k in names for k in ("vtx_x", "vtx_y", "vtx_z")):
        return np.stack(
            [particles[k].astype(np.float32) for k in ("vtx_x", "vtx_y", "vtx_z")],
            axis=-1,
        )
    return None


def _parse_group_meta(group) -> Optional[Dict]:
    """Best-effort detector meta from a sparse-tensor group: our writer's
    JSON ``meta`` attr, or an ``image_meta``/``metas`` dataset of JSON
    strings.  None when absent/unrecognized (caller falls back to the
    config's hard-coded detector meta, as the reference does)."""
    if "meta" in group.attrs:
        try:
            return json.loads(group.attrs["meta"])
        except (TypeError, ValueError):
            return None
    for name in ("image_meta", "metas", "meta"):
        if name in group:
            try:
                raw = group[name][0]
                if isinstance(raw, bytes):
                    raw = raw.decode()
                m = json.loads(raw)
                # larcv3 ImageMeta JSON uses number_of_voxels
                if "n_voxels" not in m and "number_of_voxels" in m:
                    m["n_voxels"] = m["number_of_voxels"]
                return m if "n_voxels" in m else None
            except Exception:
                return None
    return None


class LarcvWriter:
    """Streaming writer for the larcv3-style HDF5 layout above."""

    def __init__(
        self,
        path: str | Path,
        image_producer: str,
        n_projections: int,
        meta: Dict,
        dimension: int = 3,
    ):
        import h5py

        self.f = h5py.File(path, "w")
        self.dimension = dimension
        self.image_producer = image_producer
        self.n_projections = n_projections
        self.meta = meta
        self._datatype = f"sparse{dimension}d"
        self._image: Dict[str, List] = dict(
            extents=[], voxel_extents=[], voxels=[]
        )
        self._particles: Dict[str, Dict[str, List]] = {}

    def write_event(
        self,
        projections: Sequence[Tuple[np.ndarray, np.ndarray]],
        labels: Optional[Dict[str, int]] = None,
        energy: float = 0.0,
        vertex: Sequence[float] = (0.0, 0.0, 0.0),
    ):
        """projections: list of (linear_voxel_ids u64[n], values f32[n])."""
        assert len(projections) == self.n_projections
        ext_first = len(self._image["voxel_extents"])
        for ids, vals in projections:
            v_first = len(self._image["voxels"])
            self._image["voxels"].extend(zip(ids.tolist(), vals.tolist()))
            self._image["voxel_extents"].append((v_first, len(ids)))
        self._image["extents"].append((ext_first, self.n_projections))

        def add_particle(producer, pdg, edep):
            store = self._particles.setdefault(
                producer, dict(extents=[], particles=[])
            )
            first = len(store["particles"])
            store["particles"].append(
                (len(store["extents"]), pdg, edep, edep, tuple(vertex))
            )
            store["extents"].append((first, 1))

        if labels is not None:
            for key in LABEL_PRODUCERS:
                add_particle(key, int(labels[f"label{key}"]), energy)
            add_particle("event", 0, energy)

    def close(self):
        grp = self.f.require_group("Data")
        g = grp.create_group(f"{self._datatype}_{self.image_producer}_group")
        g.create_dataset(
            "extents", data=np.array(self._image["extents"], EXTENT_DTYPE)
        )
        g.create_dataset(
            "voxel_extents",
            data=np.array(self._image["voxel_extents"], EXTENT_DTYPE),
        )
        g.create_dataset(
            "voxels", data=np.array(self._image["voxels"], VOXEL_DTYPE)
        )
        g.attrs["meta"] = json.dumps(self.meta)
        for producer, store in self._particles.items():
            pg = grp.create_group(f"particle_{producer}_group")
            pg.create_dataset(
                "extents", data=np.array(store["extents"], EXTENT_DTYPE)
            )
            pg.create_dataset(
                "particles", data=np.array(store["particles"], PARTICLE_DTYPE)
            )
        self.f.close()


class LarcvDataset:
    """Random-access event reader with the dataset interface BatchLoader
    expects (__len__, batch(indices), image_size, batch_grid).

    Emits the same padded batch dict the larcv BatchFillers produce
    (image [B, (planes,) MaxVoxels, D+1] with -999 fill + label arrays,
    data_transforms.py:6-17 contract).

    ``native`` (default): voxel slabs are read by the host engine's HDF5
    reader when a library loads (``hostio.have_native_hdf5``), else by h5py,
    and 3D batches are assembled by the native assembler.  ``native=False``
    reads through h5py and assembles with numpy, the plain versions.  The
    route is logged once, at construction (``read_route``).
    ``LarcvDataset.from_events`` serves events held in memory (no file, no
    h5py) through the same batch assembly.
    """

    def __init__(
        self,
        path: str | Path,
        image_key: str,
        dimension: int = 3,
        max_voxels: int = 50000,
        normalize: bool = True,
        read_labels: bool = True,
        image_size: Optional[Tuple[int, ...]] = None,
        native: bool = True,
    ):
        import h5py

        path = str(path)
        self.f = h5py.File(path, "r")
        self.image_key = image_key
        data = self.f["Data"]
        gname = f"sparse{dimension}d_{image_key}_group"
        if gname not in data:
            raise KeyError(
                f"{gname} not in {path}; groups: {list(data.keys())}"
            )
        g = data[gname]
        self._voxel_dataset = f"/Data/{gname}/voxels"
        self.extents = _read_extents(g["extents"])
        self.voxel_extents = _read_extents(g["voxel_extents"])
        self.voxels = g["voxels"]  # lazy: potentially huge
        self.meta = _parse_group_meta(g)

        def first_particle_rows(pg) -> tuple:
            """(particles, per-event first-row index).  Real larcv3 maps
            events to particle rows through extents; these label/event
            producers carry one particle per event but we never assume
            row i == event i."""
            particles = pg["particles"][:]
            ext = _read_extents(pg["extents"]) if "extents" in pg else None
            if ext is not None and len(ext) == len(self.extents):
                rows = ext["first"].astype(np.int64)
            else:
                rows = np.arange(len(particles), dtype=np.int64)
            return particles, rows

        labels: Dict[str, np.ndarray] = {}
        if read_labels:
            for key in LABEL_PRODUCERS:
                pg_name = f"particle_{key}_group"
                if pg_name in data:
                    particles, rows = first_particle_rows(data[pg_name])
                    labels[f"label{key}"] = (
                        particles["pdg"][rows].astype(np.int32)
                    )
        energy = vertex = None
        if "particle_event_group" in data:
            particles, rows = first_particle_rows(data["particle_event_group"])
            energy = particles["energy_deposit"][rows].astype(np.float64)
            vtx = _particle_vertex(particles)
            if vtx is not None:
                # yolo-task regression target (voxel units here; the
                # reference builds it from particle data,
                # vertex_finding.py:294-359)
                vertex = vtx[rows]

        if self.meta is not None:
            # in-file meta wins when present (our writer emits it; golden
            # files may be smaller than the detector grid)
            grid = np.ravel(self.meta["n_voxels"])
        elif image_size is not None:
            # fallback for real larcv3 files, which carry no meta the
            # reference reads — it hard-codes the grid per detector
            # (larcv_fetcher.py:16-57) and so do we (config DETECTOR_META)
            grid = image_size
        else:
            raise ValueError(
                f"{path}: no parseable meta in {gname} — pass "
                f"image_size= (the detector grid, DETECTOR_META in config)"
            )
        n_projections = int(self.extents["n"][0]) if len(self.extents) else 1
        self._serve(path, dimension, grid, n_projections, labels, energy,
                    vertex, max_voxels, normalize, native)

    @classmethod
    def from_events(cls, events: Sequence[List[Tuple[np.ndarray, np.ndarray]]],
                    grid: Sequence[int], dimension: int = 3,
                    labels: Optional[Dict[str, np.ndarray]] = None,
                    energy: Optional[np.ndarray] = None,
                    vertex: Optional[np.ndarray] = None,
                    max_voxels: int = 50000, normalize: bool = True,
                    native: bool = True, name: str = "memory"):
        """A dataset over events held in memory, no file: ``events[i]`` is
        event i's projections, each (linear ids in ``grid``, values), as
        the file's voxel slabs; ``labels`` (``label<producer>`` -> i32[n]),
        ``energy`` f8[n] and ``vertex`` f32[n, 3] per event.  Its batches
        are those of a file holding the same (``write_synthetic_larcv_
        file`` and ``synthetic_larcv_event`` make one of each)."""
        self = cls.__new__(cls)
        self.f = None
        self._serve(name, dimension, grid, len(events[0]) if events else 1,
                    labels or {}, energy, vertex, max_voxels, normalize,
                    native, events)
        return self

    def _serve(self, path: str, dimension: int, grid, n_projections: int,
               labels, energy, vertex, max_voxels: int, normalize: bool,
               native: bool, events=None) -> None:
        """Set what ``batch`` reads, for both constructors; ``events`` (in
        memory) take the place of the file's voxel slabs."""
        self.path = path
        self.dimension = dimension
        self._grid = tuple(int(v) for v in grid)
        self.n_projections = n_projections
        self.labels: Dict[str, np.ndarray] = labels
        self.energy = energy
        self.vertex = vertex
        self.max_voxels = max_voxels
        self.normalize = normalize
        self.native = native
        self._events = events
        self._hdf5 = (hostio.hdf5_library() if native and events is None
                      else None)
        self.read_route = ("memory" if events is not None
                           else f"native ({self._hdf5})" if self._hdf5
                           else "h5py")
        logger.info("%s: %d events, reads %s", self.path, len(self),
                    self.read_route)

    def __len__(self) -> int:
        if self._events is not None:
            return len(self._events)
        return len(self.extents)

    def image_size(self) -> Tuple[int, ...]:
        if self.dimension == 2:
            return (self.n_projections, *self._grid)
        return tuple(self._grid)

    def batch_grid(self) -> Tuple[int, ...]:
        """The grid the batches' coordinates live on (2D: plane axis first)."""
        return self.image_size()

    def close(self) -> None:
        if self.f is not None:
            self.f.close()

    def _event_voxels(self, index: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        first, n = self.extents[index]["first"], self.extents[index]["n"]
        out = []
        for p in range(int(n)):
            ve = self.voxel_extents[int(first) + p]
            v = self.voxels[int(ve["first"]) : int(ve["first"]) + int(ve["n"])]
            out.append((v["id"].astype(np.int64), v["value"].astype(np.float32)))
        return out

    def _unravel(self, ids: np.ndarray) -> np.ndarray:
        """linear id -> coords using the projection grid (row-major)."""
        grid = self._grid
        coords = np.empty((len(ids), len(grid)), np.int32)
        rem = ids
        for d in range(len(grid) - 1, 0, -1):
            coords[:, d] = rem % grid[d]
            rem = rem // grid[d]
        coords[:, 0] = rem
        return coords

    def _native_projection_voxels(self, indices, projections: Optional[int]):
        """One slab per (event, projection) — the first ``projections`` of
        each event, all of them for None — read in one native call (the
        role larcv3's C++ IOManager plays, larcv_fetcher.py:59-77)."""
        slabs, counts = [], []
        for idx in indices:
            ext = self.extents[int(idx)]
            first, n = int(ext["first"]), int(ext["n"])
            n = n if projections is None else min(n, projections)
            for p in range(n):
                ve = self.voxel_extents[first + p]
                slabs.append((int(ve["first"]), int(ve["n"])))
            counts.append(n)
        flat = hostio.read_voxel_slabs(self.path, self._voxel_dataset, slabs,
                                       self._hdf5)
        out, pos = [], 0
        for n in counts:
            out.append(flat[pos : pos + n])
            pos += n
        return out

    def _voxels_of(self, indices, projections: Optional[int] = None):
        """Per event, its projections' (ids, values)."""
        if self._events is not None:
            return [self._events[int(i)][:projections] for i in indices]
        if self._hdf5:
            return self._native_projection_voxels(indices, projections)
        return [self._event_voxels(int(idx))[:projections] for idx in indices]

    def batch(self, indices) -> Dict[str, np.ndarray]:
        b = len(indices)
        d = len(self._grid)
        if self.dimension == 3:
            events = [
                (np.asarray(ids, np.uint64), vals)
                for projections in self._voxels_of(indices, 1)
                for ids, vals in projections
            ]
            image = hostio.assemble_sparse_batch(
                events, self.max_voxels, self._grid, normalize=self.normalize,
                native=self.native,
            )
        else:
            image = np.full(
                (b, self.n_projections, self.max_voxels, d + 1), -999.0,
                np.float32,
            )
            for i, projections in enumerate(self._voxels_of(indices)):
                for p, (ids, vals) in enumerate(projections):
                    ids = np.asarray(ids, np.int64)
                    if self.normalize and len(vals) > 1:
                        mu, sd = vals.mean(), vals.std() + 1e-6
                        vals = (vals - mu) / sd * 0.5 + 1.0
                    k = min(len(ids), self.max_voxels)
                    coords = self._unravel(ids[:k])
                    # BatchFiller2D stores (x, y, value): the row-major MAJOR
                    # axis of the projection grid is y (reference scn coords
                    # are [plane, y, x] against (planes,) + n_voxels —
                    # data_transforms.py:242), so emit (minor, major).
                    image[i, p, :k, 0] = coords[:, 1]
                    image[i, p, :k, 1] = coords[:, 0]
                    image[i, p, :k, d] = vals[:k]
        out = {
            "image": image,
            # event ids for downstream per-event memoization (plan cache)
            "index": np.asarray(indices, np.int64),
        }
        for key, arr in self.labels.items():
            out[key] = arr[np.asarray(indices, np.int64)]
        if self.energy is not None:
            out["energy"] = self.energy[np.asarray(indices, np.int64)]
        if self.vertex is not None:
            out["vertex"] = self.vertex[np.asarray(indices, np.int64)]
        return out


def synthetic_larcv_grid(image_size: Sequence[int],
                         planes: bool = False) -> Tuple[int, ...]:
    """The grid a synthetic larcv file's voxel ids are linear in (its
    ``meta`` ``n_voxels``): ``image_size``, or (H, W) for ``planes``."""
    return tuple(int(v) for v in (image_size[1:] if planes else image_size))


def synthetic_larcv_event(index: int, image_size: Sequence[int], seed: int,
                          mean_tracks: float, steps_per_track: int,
                          max_voxels: int, planes: bool = False):
    """Event ``index`` of a synthetic larcv file -> (projections, a list of
    (linear ids u64[n], values f32[n]), labels, aux): the events of
    ``SyntheticDataset(..., seed=seed).event(index)``, unnormalized.

    Without ``planes`` the one projection holds the event's voxels, their
    ids linear in ``image_size`` (the JAX writer's layout).  With
    ``planes`` ``image_size`` is (P, H, W): the tracks are generated on
    (H, H, W), as the synthetic 2D split generates them, and projection p
    projects out axis p % 3, keeps the pixels inside (H, W) and sums the
    charge of the voxels that share a pixel, ids linear in (H, W) (the
    layout the 2D reader reads as P wire planes)."""
    from .synthetic import SyntheticEventConfig, generate_event

    size = tuple(int(v) for v in image_size)
    gen_size = (size[1],) + size[1:] if planes else size
    cfg = SyntheticEventConfig(
        image_size=gen_size,
        normalize=False,
        mean_tracks=mean_tracks,
        steps_per_track=steps_per_track,
        max_voxels=max_voxels,
    )
    coords, vals, labels, aux = generate_event(
        np.random.default_rng((seed, index)), cfg)
    if not planes:
        lin = coords[:, 0].astype(np.int64)
        for dd in range(1, len(size)):
            lin = lin * size[dd] + coords[:, dd]
        return [(lin.astype(np.uint64), vals)], labels, aux
    h, w = size[1:]
    projections = []
    for p in range(size[0]):
        keep = [a for a in range(3) if a != p % 3]
        c2 = coords[:, keep].astype(np.int64)
        inside = (c2[:, 0] < h) & (c2[:, 1] < w)
        ids, inv = np.unique(c2[inside, 0] * w + c2[inside, 1],
                             return_inverse=True)
        summed = np.zeros(len(ids), np.float32)
        np.add.at(summed, inv, vals[inside])
        projections.append((ids.astype(np.uint64), summed))
    return projections, labels, aux


def write_synthetic_larcv_file(
    path: str | Path,
    n_events: int,
    image_size: Tuple[int, ...] = (64, 64, 64),
    seed: int = 0,
    dimension: int = 3,
    image_producer: str = "dunevoxels",
    mean_tracks: float = 3.0,
    steps_per_track: int = 200,
    max_voxels: int = 2048,
    planes: bool = False,
):
    """Golden-test helper: a larcv3-schema file of synthetic events.

    Defaults give tiny golden-test events; pass mean_tracks≈40,
    steps_per_track≈625, max_voxels≈50000 for dune3d-occupancy events
    (~25k active voxels, the bench distribution).  Event i is the event
    ``SyntheticDataset(..., seed=seed).event(i)`` with the same settings,
    unnormalized.  ``planes`` (2D, ``image_size`` (P, H, W)) writes each
    event as P wire-plane projections (``synthetic_larcv_event``); without
    it the file is the JAX writer's, one projection of ids linear in
    ``image_size``."""
    grid = synthetic_larcv_grid(image_size, planes)
    n_projections = image_size[0] if planes else 1
    writer = LarcvWriter(path, image_producer, n_projections,
                         dict(n_voxels=list(grid)), dimension=dimension)
    for i in range(n_events):
        projections, labels, aux = synthetic_larcv_event(
            i, image_size, seed, mean_tracks, steps_per_track, max_voxels,
            planes)
        writer.write_event(
            projections,
            labels=labels,
            energy=float(aux["energy"]),
            vertex=tuple(float(v) for v in aux["vertex"]),
        )
    writer.close()
    return path
