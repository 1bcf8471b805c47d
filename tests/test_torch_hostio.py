"""The port's host IO engine (csrc/hostio.cpp, built with g++ here) against
the JAX package's numpy assembler and h5py: the same events, made from a
seed, through both."""

import threading

import h5py
import numpy as np
import pytest

from sparseeventid_tpu.io.hostio import _assemble_numpy as jax_numpy
from sparseeventid_tpu.io.larcv import write_synthetic_larcv_file as jwrite
from sparseeventid_tpu_torch.io import hostio

GRID = (32, 32, 32)


def make_events(n_events=4, n=300, grid=GRID, seed=0):
    rng = np.random.default_rng(seed)
    total = int(np.prod(grid))
    return [
        (
            rng.choice(total, n + 7 * i, replace=False).astype(np.uint64),
            np.abs(rng.standard_normal(n + 7 * i)).astype(np.float32) + 0.1,
        )
        for i in range(n_events)
    ]


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("threads", [1, 3, 0])
def test_native_matches_jax_numpy(normalize, threads):
    """Coordinates and padding equal; values within 1e-5 (the native
    normalization sums in double, numpy in float32 pairs)."""
    events = make_events(seed=3)
    got, used = hostio.assemble_native(events, 512, GRID, normalize=normalize,
                                       threads=threads)
    want = jax_numpy(events, 512, GRID, normalize, False, 0.0, None, 0)
    assert got.shape == want.shape == (4, 512, 4)
    assert 1 <= used <= 4 and (threads == 0 or used == min(threads, 4))
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    np.testing.assert_array_equal(got[..., 3] == -999.0, want[..., 3] == -999.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("augment", [False, True])
def test_numpy_version_is_the_jax_one(augment):
    events = make_events(seed=5)
    args = (events, 400, GRID, True, augment, 0.05, [3, 3, 3], 9)
    np.testing.assert_array_equal(
        hostio.assemble_sparse_batch(*args[:3], normalize=True, augment=augment,
                                     blur_sigma=0.05, translate=[3, 3, 3],
                                     seed=9, native=False),
        jax_numpy(*args))


@pytest.mark.parametrize("native", [True, False])
def test_truncation_at_max_voxels(native):
    events = make_events(n_events=2, n=300)
    out = hostio.assemble_sparse_batch(events, 100, GRID, normalize=False,
                                       native=native)
    assert out.shape == (2, 100, 4)
    assert np.all(out[..., 3] != -999.0)
    # the first 100 voxels of each event, in order
    ids = out[0, :, :3].astype(np.int64) @ np.array([32 * 32, 32, 1])
    np.testing.assert_array_equal(ids, events[0][0][:100].astype(np.int64))


def test_native_augment_deterministic_and_bounded():
    events = make_events(n_events=3, seed=4)
    kw = dict(normalize=False, augment=True, translate=[4, 4, 4], seed=11)
    a1 = hostio.assemble_sparse_batch(events, 512, GRID, **kw)
    a2 = hostio.assemble_sparse_batch(events, 512, GRID, **kw)
    np.testing.assert_array_equal(a1, a2)
    serial, _ = hostio.assemble_native(events, 512, GRID, threads=1, **kw)
    np.testing.assert_array_equal(a1, serial)  # an event's draws are its own
    valid = np.all(a1[..., :3] != -999.0, axis=-1)
    c = a1[valid][:, :3]
    assert c.min() >= 0 and c.max() < 32
    plain = hostio.assemble_sparse_batch(events, 512, GRID, normalize=False)
    assert not np.array_equal(a1, plain)


def test_empty_and_short_events():
    events = [(np.zeros(0, np.uint64), np.zeros(0, np.float32)),
              (np.array([5], np.uint64), np.array([2.0], np.float32))]
    got = hostio.assemble_sparse_batch(events, 8, GRID)
    want = jax_numpy(events, 8, GRID, True, False, 0.0, None, 0)
    np.testing.assert_array_equal(got, want)


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="dims"):
        hostio.assemble_native(make_events(1), 8, (2, 2, 2, 2))
    with pytest.raises(ValueError, match="as many values"):
        hostio.assemble_native([(np.zeros(3, np.uint64), np.zeros(2, np.float32))],
                               8, GRID)


# ---- the build

def test_parallel_builds_never_expose_a_partial_library(tmp_path, monkeypatch):
    """Several builders at once (test workers) each compile to their own
    file and move it into place: every one ends with a loadable library and
    no temporary file is left."""
    import ctypes

    monkeypatch.setattr(hostio, "BUILD_DIR", tmp_path)
    out = tmp_path / "hostio_test.so"
    errors = []

    def build():
        try:
            hostio._build(out)
            ctypes.CDLL(str(out)).seid_hdf5_load  # loads and binds
        except Exception as e:  # collected and failed on below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [p.name for p in tmp_path.iterdir()] == ["hostio_test.so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "hostio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(hostio, "SOURCE", bad)
    monkeypatch.setattr(hostio, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        hostio._build(tmp_path / "hostio_bad.so")
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_library_is_named_by_source_and_flags():
    lib = hostio.library()
    assert lib._name == str(hostio._target())
    assert hostio._target().parent == hostio.ROOT / "build" / "host"


# ---- the HDF5 slab reader

@pytest.fixture(scope="module")
def larcv_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("hostio") / "g.h5"
    jwrite(path, 12, image_size=GRID, seed=5)
    return path


@pytest.mark.parametrize("library", ["libhdf5_serial.so.103", "h5py"])
def test_native_slab_reads_match_h5py(library, larcv_file):
    """Byte-identical to h5py's reads of the same rows, through the system
    library and through the copy h5py bundles (found by path)."""
    name = hostio.h5py_hdf5()[0] if library == "h5py" else library
    if hostio.hdf5_handle(name) is None:
        pytest.skip(f"{name} does not load on this host")
    ds = "/Data/sparse3d_dunevoxels_group/voxels"
    with h5py.File(larcv_file, "r") as f:
        raw = f[ds][:]
        ve = f["Data/sparse3d_dunevoxels_group/voxel_extents"][:]
    slabs = [(int(ve[i]["first"]), int(ve[i]["n"])) for i in (3, 0, 7, 11, 0)]
    slabs.append((int(ve[2]["first"]), 0))
    got = hostio.read_voxel_slabs(str(larcv_file), ds, slabs, name)
    assert len(got) == len(slabs)
    for (first, n), (ids, vals) in zip(slabs, got):
        assert ids.dtype == np.uint64 and vals.dtype == np.float32
        assert ids.tobytes() == raw["id"][first:first + n].astype(np.uint64).tobytes()
        assert vals.tobytes() == raw["value"][first:first + n].astype(np.float32).tobytes()


def test_h5py_library_is_found_by_path():
    paths = hostio.h5py_hdf5()
    assert paths and all("/h5py.libs/libhdf5-" in p for p in paths)
    assert hostio.hdf5_library() in (*hostio.SYSTEM_HDF5, *paths)
    assert hostio.have_native_hdf5()
    assert hostio.hdf5_handle("libhdf5-not-a-library.so") is None


def test_failed_read_raises(larcv_file):
    with pytest.raises(OSError, match="HDF5 read failed"):
        hostio.read_voxel_slabs(str(larcv_file), "/Data/no_such_group/voxels",
                                [(0, 3)])
    with pytest.raises(OSError, match="HDF5 read failed"):
        hostio.read_voxel_slabs(str(larcv_file) + ".missing",
                                "/Data/sparse3d_dunevoxels_group/voxels", [(0, 3)])
    assert hostio.read_voxel_slabs(str(larcv_file), "x", []) == []
