"""Host IO engine: threaded event -> padded COO batch assembly, the native
HDF5 voxel-slab reader and the threaded window-plan builder (JAX
counterpart: ``io/hostio.py`` over the ``_hostio`` extension).

``csrc/hostio.cpp`` (with the plan builder of ``csrc/hostio_core.h``) is
compiled by g++ into a shared library with a plain C
interface at first use, under ``build/host/`` at the repository root, named
by a hash of its source and flags, and loaded with ctypes (which releases
the interpreter lock for each call).  A failed build raises with the
compiler's output; nothing falls back to numpy unless the caller asks for
``native=False``.  ``_assemble_numpy`` is the plain version.

HDF5 is bound by dlopen: a system library first (``SYSTEM_HDF5``), else the
copy h5py bundles, found by path under ``h5py.libs``.  That copy is the
library h5py itself runs, whose lock the native reader does not take, so a
native read must not overlap an h5py call in another thread; ``LarcvDataset``
calls h5py only when it opens and closes, not while its loader reads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hostio.cpp"
HEADERS = (SOURCE.with_name("hostio_core.h"),)
BUILD_DIR = ROOT / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-shared", "-fPIC")
SYSTEM_HDF5 = ("libhdf5_serial.so.103", "libhdf5.so.310", "libhdf5.so")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_lock = threading.Lock()
_hdf5_lock = threading.Lock()
_lib: List[ctypes.CDLL] = []
_hdf5: Dict[str, Optional[int]] = {}


def _target() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"hostio_{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host IO engine is built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # parallel builders (test workers) each write their own file and move
    # it into place: no process ever loads a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-ldl"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded host IO library, built on first use."""
    with _lock:
        if not _lib:
            out = _target()
            if not out.exists():
                _build(out)
            dll = ctypes.CDLL(str(out))
            dll.seid_assemble_sparse_batch.argtypes = [
                _P, _P, _P, _I64, _I64, _P, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, _P, ctypes.c_uint64, ctypes.c_int,
                _P]
            dll.seid_assemble_sparse_batch.restype = ctypes.c_int
            dll.seid_hdf5_load.argtypes = [ctypes.c_char_p]
            dll.seid_hdf5_load.restype = _P
            dll.seid_read_voxel_slabs.argtypes = [
                _P, ctypes.c_char_p, ctypes.c_char_p, _P, _P, _I64, _P, _P]
            dll.seid_read_voxel_slabs.restype = ctypes.c_int
            dll.seid_build_window_plans.argtypes = [
                _P, _I64, _I64, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64,
                _I64, _P, _I64, _P, _P]
            dll.seid_build_window_plans.restype = _I64
            dll.seid_plan_pool_peak_concurrency.argtypes = []
            dll.seid_plan_pool_peak_concurrency.restype = _I64
            _lib.append(dll)
        return _lib[0]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def assemble_native(
    events: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_voxels: int,
    dims: Sequence[int],
    normalize: bool = True,
    augment: bool = False,
    blur_sigma: float = 0.05,
    translate: Optional[Sequence[int]] = None,
    seed: int = 0,
    threads: int = 0,
) -> Tuple[np.ndarray, int]:
    """The native assembly -> (batch, threads used).  ``threads`` 0: one a
    hardware thread, at most one an event."""
    d = len(dims)
    if not 1 <= d <= 3:
        raise ValueError(f"dims must have 1..3 entries, got {tuple(dims)}")
    ids = [np.asarray(i, np.uint64).ravel() for i, _ in events]
    vals = [np.asarray(v, np.float32).ravel() for _, v in events]
    if any(len(i) != len(v) for i, v in zip(ids, vals)):
        raise ValueError("each event needs as many values as ids")
    offsets = np.zeros(len(events) + 1, np.int64)
    np.cumsum([len(i) for i in ids], out=offsets[1:])
    flat_ids = np.ascontiguousarray(np.concatenate(ids) if ids else
                                    np.zeros(0, np.uint64))
    flat_vals = np.ascontiguousarray(np.concatenate(vals) if vals else
                                     np.zeros(0, np.float32))
    dims_arr = np.asarray(dims, np.int64)
    shift = np.zeros(3, np.int32)
    if translate is not None:
        shift[:min(d, len(translate))] = np.asarray(translate[:d], np.int32)
    out = np.empty((len(events), int(max_voxels), d + 1), np.float32)
    used = library().seid_assemble_sparse_batch(
        _ptr(flat_ids), _ptr(flat_vals), _ptr(offsets), len(events),
        int(max_voxels), _ptr(dims_arr), d, int(bool(normalize)),
        int(bool(augment)), float(blur_sigma), _ptr(shift), int(seed),
        int(threads), _ptr(out))
    if used < 0:
        raise ValueError("seid_assemble_sparse_batch refused its arguments")
    return out, used


def assemble_sparse_batch(
    events: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_voxels: int,
    dims: Sequence[int],
    normalize: bool = True,
    augment: bool = False,
    blur_sigma: float = 0.05,
    translate: Optional[Sequence[int]] = None,
    seed: int = 0,
    native: bool = True,
) -> np.ndarray:
    """events: list of (linear ids u64[n], values f32[n]) ->
    [B, max_voxels, D+1] padded batch (-999 fill).  ``native=False`` runs
    the numpy version."""
    if native:
        return assemble_native(events, max_voxels, dims, normalize, augment,
                               blur_sigma, translate, seed)[0]
    return _assemble_numpy(events, max_voxels, dims, normalize, augment,
                           blur_sigma, translate, seed)


def _assemble_numpy(
    events, max_voxels, dims, normalize, augment, blur_sigma, translate, seed
) -> np.ndarray:
    b = len(events)
    d = len(dims)
    out = np.full((b, max_voxels, d + 1), -999.0, np.float32)
    dims_arr = np.asarray(dims, np.int64)
    for bi, (ids, vals) in enumerate(events):
        ids = np.asarray(ids, np.uint64)
        vals = np.asarray(vals, np.float32)
        if normalize and len(vals) > 1:
            mu, sd = vals.mean(), vals.std() + 1e-6
            vals = (vals - mu) / sd * 0.5 + 1.0
        coords = np.empty((len(ids), d), np.int64)
        rem = ids.astype(np.int64)
        for dd in range(d - 1, 0, -1):
            coords[:, dd] = rem % dims_arr[dd]
            rem = rem // dims_arr[dd]
        coords[:, 0] = rem
        if augment:
            rng = np.random.default_rng((seed, bi))
            for dd in range(d):
                if rng.random() < 0.5:
                    coords[:, dd] = dims_arr[dd] - 1 - coords[:, dd]
            if blur_sigma > 0:
                coords = np.rint(
                    coords + rng.normal(scale=blur_sigma, size=coords.shape)
                ).astype(np.int64)
            if translate is not None:
                shift = np.array(
                    [rng.integers(-t, t + 1) for t in translate[:d]]
                )
                coords = coords + shift
            ok = np.all((coords >= 0) & (coords < dims_arr), axis=1)
            coords, vals = coords[ok], vals[ok]
        k = min(len(coords), max_voxels)
        out[bi, :k, :d] = coords[:k]
        out[bi, :k, d] = vals[:k]
    return out


# ---- window plans -------------------------------------------------------------

def _triple(v) -> Tuple[int, int, int]:
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 entries, got {t}")
    return t


def _plan_layout(caps: Sequence[int], initial_kernel, series_kernels, stride,
                ov_caps: Sequence[int], ov_cap_initial: int,
                ov_caps_down: Sequence[int], batch: int):
    """The plan dict's keys, in the order of the C entry's outputs, each
    with its shape and dtype."""
    depth = len(caps) - 1
    tiles = [-(-int(c) // 128) for c in caps]
    kd = int(np.prod(stride))
    out = []
    for l, cap in enumerate(caps):
        out += [(f"lvl{l}/coords", (batch, int(cap), 3), np.int32),
                (f"lvl{l}/n_active", (batch,), np.int32),
                (f"lvl{l}/site_dropped", (batch,), np.int32)]
    plans = [("initial", tiles[0], int(np.prod(initial_kernel)),
              ov_cap_initial)]
    plans += [(f"lvl{l}/series", tiles[l], int(np.prod(series_kernels[l])),
               ov_caps[l]) for l in range(depth + 1)]
    plans += [(f"lvl{l}/down_f", tiles[l + 1], kd, ov_caps_down[l])
              for l in range(depth)]
    plans += [(f"lvl{l}/down_r", tiles[l], kd, ov_caps_down[l])
              for l in range(depth)]
    for prefix, n_tiles, k, width in plans:
        width = int(width)
        out += [(f"{prefix}/start", (batch, n_tiles, k), np.int32),
                (f"{prefix}/ov_src", (batch, width), np.int32),
                (f"{prefix}/ov_dst", (batch, width), np.int32),
                (f"{prefix}/ov_k", (batch, width), np.int32),
                (f"{prefix}/ov_valid", (batch, width), np.bool_),
                (f"{prefix}/ov_dropped", (batch,), np.int32)]
    return out


def build_window_plans(
    coords: np.ndarray,  # i32[B, cap0, 3], -1 padded (unsorted ok)
    grid: Sequence[int],
    caps: Sequence[int],
    initial_kernel: Sequence[int],
    series_kernel,  # (k0, k1, k2) or per-level [(k0, k1, k2)] * (depth + 1)
    stride: Sequence[int],
    window_r: int,
    ov_caps: Sequence[int],
    ov_cap_initial: int,
    ov_caps_down: Sequence[int],
    window_r_down: int = 0,
    window_r_initial: int = 0,
    window_r_series: Sequence[int] | None = None,
) -> Dict[str, np.ndarray]:
    """Threaded site pyramid and window plans of a batch, on the host.

    A pure function of the coordinates: the loader's thread runs it so the
    device never builds plans.  Keys: ``lvl{l}/coords|n_active|
    site_dropped``, and ``{initial, lvl{l}/series, lvl{l}/down_f,
    lvl{l}/down_r}/start|ov_src|ov_dst|ov_k|ov_valid|ov_dropped``, as the
    JAX builder's.  Each list holds only real out-of-window pairs, in
    (dst, k) order.  ``window_r`` is the series window (and the reverse
    plans'); ``window_r_down`` / ``window_r_initial`` 0 mean ``window_r``;
    ``window_r_series`` gives one window a level.  The geometry must be the
    one the convs are given (``ops.host_plans.encoder_plans_from_host``).
    """
    coords = np.ascontiguousarray(coords, np.int32)
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coords must be [B, N, 3], got {coords.shape}")
    b, cap0 = coords.shape[:2]
    caps = [int(c) for c in caps]
    depth = len(caps) - 1
    if caps[0] < cap0:
        raise ValueError(f"caps[0] ({caps[0]}) must be >= coords.shape[1] ({cap0})")
    if hasattr(series_kernel[0], "__len__"):
        series = [_triple(k) for k in series_kernel]
        if len(series) != depth + 1:
            raise ValueError("per-level series_kernel needs depth + 1 entries")
    else:
        series = [_triple(series_kernel)] * (depth + 1)
    window_r = int(window_r)
    r_series = ([window_r] * (depth + 1) if window_r_series is None else
                [int(r) if int(r) > 0 else window_r for r in window_r_series])
    if len(r_series) != depth + 1 or len(ov_caps) != depth + 1 \
            or len(ov_caps_down) != depth:
        raise ValueError("per-level windows and widths need depth + 1 "
                         "(downsample: depth) entries")
    layout = _plan_layout(caps, initial_kernel, series, stride, ov_caps,
                         ov_cap_initial, ov_caps_down, b)
    out = {key: np.empty(shape, dtype) for key, shape, dtype in layout}
    pointers = (ctypes.c_void_p * len(layout))(
        *[_ptr(out[key]) for key, _, _ in layout])
    i64 = lambda v: np.ascontiguousarray(v, np.int64)
    args = dict(
        grid=i64(_triple(grid)), caps=i64(caps),
        initial=i64(_triple(initial_kernel)), series=i64(series),
        stride=i64(_triple(stride)), r_series=i64(r_series),
        ov_caps=i64([int(c) for c in ov_caps]),
        ov_caps_down=i64([int(c) for c in ov_caps_down] or [0]),
    )
    used = library().seid_build_window_plans(
        _ptr(coords), b, cap0, _ptr(args["grid"]), depth, _ptr(args["caps"]),
        _ptr(args["initial"]), _ptr(args["series"]), _ptr(args["stride"]),
        _ptr(args["r_series"]), int(window_r_initial) or window_r,
        int(window_r_down) or window_r, window_r, _ptr(args["ov_caps"]),
        int(ov_cap_initial), _ptr(args["ov_caps_down"]), pointers)
    if used < 0:
        raise ValueError("seid_build_window_plans refused its arguments")
    return out


def plan_pool_peak_concurrency() -> int:
    """The most plan-pool workers inside the per-event builder at once since
    the last call (which this one resets): 1 under SEID_PLAN_THREADS=1."""
    return int(library().seid_plan_pool_peak_concurrency())


# ---- HDF5 --------------------------------------------------------------------

def h5py_hdf5() -> List[str]:
    """Paths of the HDF5 libraries h5py bundles (none without h5py)."""
    try:
        import h5py
    except ModuleNotFoundError:
        return []
    libs = Path(h5py.__file__).resolve().parent.parent / "h5py.libs"
    return sorted(str(p) for p in libs.glob("libhdf5-*.so*"))


def hdf5_handle(name: str) -> Optional[int]:
    """The handle of the HDF5 library ``name`` (soname or path) bound by
    the host library, or None if it does not load."""
    with _hdf5_lock:
        if name not in _hdf5:
            _hdf5[name] = library().seid_hdf5_load(name.encode()) or None
        return _hdf5[name]


def hdf5_library() -> Optional[str]:
    """The HDF5 library the native reader uses: the first system soname
    that loads, else h5py's bundled copy; None if neither does."""
    for name in (*SYSTEM_HDF5, *h5py_hdf5()):
        if hdf5_handle(name) is not None:
            return name
    return None


def have_native_hdf5() -> bool:
    return hdf5_library() is not None


def read_voxel_slabs(
    path: str, dataset: str, slabs: Sequence[Tuple[int, int]],
    library_name: Optional[str] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Rows [first, first + n) of the voxel compound ``dataset`` for each
    (first, n) -> [(ids u64[n], values f32[n]), ...], one native call that
    reads every slab under the reader's mutex.  ``library_name`` picks the
    HDF5 library (default ``hdf5_library()``)."""
    name = library_name or hdf5_library()
    handle = hdf5_handle(name) if name else None
    if handle is None:
        raise RuntimeError(f"no loadable HDF5 library ({name or 'none found'})")
    if not slabs:
        return []
    first = np.ascontiguousarray([s[0] for s in slabs], np.uint64)
    count = np.ascontiguousarray([s[1] for s in slabs], np.uint64)
    total = int(count.sum())
    ids = np.empty(total, np.uint64)
    vals = np.empty(total, np.float32)
    err = library().seid_read_voxel_slabs(
        handle, str(path).encode(), dataset.encode(), _ptr(first),
        _ptr(count), len(slabs), _ptr(ids), _ptr(vals))
    if err != 0:
        raise OSError(f"HDF5 read failed: {path}::{dataset}")
    cuts = np.cumsum(count)[:-1].astype(np.int64)
    return list(zip(np.split(ids, cuts), np.split(vals, cuts)))
