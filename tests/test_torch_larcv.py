"""The port's larcv reader and writer against the JAX package's: files
written by one package are read by the other, in 3D and in 2D multiplane,
a foreign-layout file built with raw h5py is read by both, and the .h5
softmax output keeps the JAX layout."""

import json

import h5py
import numpy as np
import pytest

from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import larcv as jlarcv
from sparseeventid_tpu_torch.io import larcv as tlarcv
from sparseeventid_tpu_torch.train.evaluate import write_softmax

GRID = (32, 32, 32)
GRID_2D = (24, 20)  # one projection's (major, minor) grid


def _assert_batches_equal(got, want, values_atol=0.0):
    assert set(got) == set(want)
    for k in want:
        if k == "image":
            np.testing.assert_array_equal(got[k][..., :-1], want[k][..., :-1])
            np.testing.assert_allclose(got[k][..., -1], want[k][..., -1],
                                       rtol=0, atol=values_atol)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def files3d(tmp_path_factory):
    d = tmp_path_factory.mktemp("larcv3d")
    kw = dict(n_events=10, image_size=GRID, seed=7)
    return (tlarcv.write_synthetic_larcv_file(d / "port.h5", **kw),
            jlarcv.write_synthetic_larcv_file(d / "jax.h5", **kw))


def test_writers_write_the_same_file(files3d):
    port, jax_file = files3d
    with h5py.File(port, "r") as a, h5py.File(jax_file, "r") as b:
        names = []
        a.visit(names.append)
        other = []
        b.visit(other.append)
        assert names == other
        for n in names:
            if isinstance(a[n], h5py.Dataset):
                assert a[n][()].tobytes() == b[n][()].tobytes(), n
        assert dict(a["Data/sparse3d_dunevoxels_group"].attrs) == dict(
            b["Data/sparse3d_dunevoxels_group"].attrs)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_3d_read_across_packages(files3d, writer, native, normalize):
    """Each package's file through the other package's reader: equal
    batches, labels, energy and vertex; bit-equal through h5py and numpy,
    values within 1e-5 through the native reads and assembly."""
    path = files3d[0] if writer == "port" else files3d[1]
    idx = [3, 0, 7, 9]
    kw = dict(dimension=3, max_voxels=512, normalize=normalize)
    want = jlarcv.LarcvDataset(path, "dunevoxels", **kw)
    got = tlarcv.LarcvDataset(path, "dunevoxels", native=native, **kw)
    assert got.read_route.startswith("native" if native else "h5py")
    assert len(got) == len(want) == 10
    assert got.image_size() == got.batch_grid() == want.image_size() == GRID
    _assert_batches_equal(got.batch(idx), want.batch(idx),
                          values_atol=1e-5 if native and normalize else 0.0)
    np.testing.assert_array_equal(got.energy, want.energy)
    np.testing.assert_array_equal(got.vertex, want.vertex)
    got.close()


def _write_2d(pkg, path, n_events=5, seed=1):
    """A 3-projection sparse2d file written with ``pkg``'s LarcvWriter."""
    rng = np.random.default_rng(seed)
    w = pkg.LarcvWriter(path, "dunevoxels", 3, dict(n_voxels=list(GRID_2D)),
                        dimension=2)
    total = GRID_2D[0] * GRID_2D[1]
    for i in range(n_events):
        projections = []
        for p in range(3):
            n = int(rng.integers(1, 60))
            ids = np.sort(rng.choice(total, n, replace=False)).astype(np.uint64)
            projections.append((ids, rng.uniform(0.1, 3.0, n).astype(np.float32)))
        labels = {k: int(rng.integers(0, c)) for k, c in OUTPUT_SHAPE.items()}
        w.write_event(projections, labels=labels, energy=float(i) + 0.5,
                      vertex=(i, 2.0 * i, 3.0 * i))
    w.close()
    return path


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("native", [False, True])
def test_2d_read_across_packages(tmp_path, writer, native):
    """(minor, major) column order, one slab per (event, projection); the
    2D branch normalizes in numpy in both packages: bit-equal."""
    path = _write_2d(tlarcv if writer == "port" else jlarcv, tmp_path / "p.h5")
    kw = dict(dimension=2, max_voxels=40, normalize=True)
    want = jlarcv.LarcvDataset(path, "dunevoxels", **kw)
    got = tlarcv.LarcvDataset(path, "dunevoxels", native=native, **kw)
    assert got.n_projections == 3
    assert got.image_size() == got.batch_grid() == (3, *GRID_2D)
    idx = [4, 1, 2]
    b = got.batch(idx)
    assert b["image"].shape == (3, 3, 40, 3)
    _assert_batches_equal(b, want.batch(idx))
    np.testing.assert_array_equal(got.vertex, want.vertex)
    got.close()


# ---- a foreign-layout file (tests/test_larcv_schema.py's contract)

EXT_DT = np.dtype([("First", "<u8"), ("N", "<u4")])
VOX_DT = np.dtype([("value", "<f4"), ("id", "<u8")])
PART_DT = np.dtype([("id", "<u4"), ("track_id", "<u4"), ("pdg", "<i4"),
                    ("vtx_x", "<f8"), ("vtx_y", "<f8"), ("vtx_z", "<f8"),
                    ("energy_deposit", "<f8"), ("creation_process", "S16")])


def _extents(counts):
    out = np.zeros(len(counts), EXT_DT)
    out["First"] = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out["N"] = counts
    return out


@pytest.fixture(scope="module")
def foreign_file(tmp_path_factory):
    """Extra particle fields, vtx_* scalars, particle rows through extents
    (the event's particle first, filler rows after), no meta."""
    path = tmp_path_factory.mktemp("foreign") / "foreign.h5"
    rng = np.random.default_rng(3)
    nvox = [37, 5, 61, 12]
    total = int(np.prod(GRID))
    with h5py.File(path, "w") as f:
        data = f.create_group("Data")
        g = data.create_group("sparse3d_dunevoxels_group")
        g.create_dataset("extents", data=_extents([1] * 4))
        g.create_dataset("voxel_extents", data=_extents(nvox))
        vox = np.zeros(sum(nvox), VOX_DT)
        vox["id"] = np.concatenate(
            [np.sort(rng.choice(total, n, replace=False)) for n in nvox])
        vox["value"] = rng.uniform(0.5, 3.0, len(vox))
        g.create_dataset("voxels", data=vox)
        for name, rows in (("particle_neutID_group", [1, 1, 1, 1]),
                           ("particle_event_group", [2, 1, 3, 1])):
            pg = data.create_group(name)
            pg.create_dataset("extents", data=_extents(rows))
            parts = np.zeros(sum(rows), PART_DT)
            parts["pdg"] = -999
            firsts = _extents(rows)["First"]
            parts["pdg"][firsts] = [2, 0, 1, 2]
            parts["energy_deposit"][firsts] = [0.7, 1.3, 2.1, 0.4]
            for k, c in zip(("vtx_x", "vtx_y", "vtx_z"), (1.0, 2.0, 3.0)):
                parts[k][firsts] = c * np.arange(1, 5)
            pg.create_dataset("particles", data=parts)
    return path


@pytest.mark.parametrize("native", [False, True])
def test_foreign_layout_reads_as_in_jax(foreign_file, native):
    kw = dict(dimension=3, max_voxels=64, normalize=False, image_size=GRID)
    want = jlarcv.LarcvDataset(foreign_file, "dunevoxels", **kw)
    got = tlarcv.LarcvDataset(foreign_file, "dunevoxels", native=native, **kw)
    assert got.labels["labelneutID"].tolist() == [2, 0, 1, 2]
    np.testing.assert_array_equal(got.energy, [0.7, 1.3, 2.1, 0.4])
    np.testing.assert_array_equal(got.vertex, want.vertex)
    _assert_batches_equal(got.batch([0, 2, 3]), want.batch([0, 2, 3]))
    with pytest.raises(ValueError, match="image_size"):
        tlarcv.LarcvDataset(foreign_file, "dunevoxels", dimension=3)
    got.close()


def test_image_meta_json_and_missing_group(tmp_path):
    path = tmp_path / "meta.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("Data").create_group("sparse2d_dunevoxels_group")
        g.create_dataset("extents", data=_extents([2]))
        g.create_dataset("voxel_extents", data=_extents([3, 3]))
        vox = np.zeros(6, VOX_DT)
        vox["id"] = [0, 5, 11, 1, 6, 10]
        vox["value"] = 1.0
        g.create_dataset("voxels", data=vox)
        meta = json.dumps({"number_of_voxels": [3, 4]})
        g.create_dataset("image_meta", data=np.array([meta.encode()] * 2))
    kw = dict(dimension=2, max_voxels=8, normalize=False, read_labels=False)
    got = tlarcv.LarcvDataset(path, "dunevoxels", **kw)
    assert got.image_size() == (2, 3, 4)
    _assert_batches_equal(got.batch([0]),
                          jlarcv.LarcvDataset(path, "dunevoxels", **kw).batch([0]))
    with pytest.raises(KeyError, match="sparse3d_dunevoxels_group"):
        tlarcv.LarcvDataset(path, "dunevoxels", dimension=3)


@pytest.mark.parametrize("native", [False, True])
def test_normalization_and_truncation(files3d, native):
    ds = tlarcv.LarcvDataset(files3d[0], "dunevoxels", max_voxels=4096,
                             native=native)
    img = ds.batch([1])["image"][0]
    vals = img[img[:, 3] != -999.0][:, 3]
    assert abs(vals.mean() - 1.0) < 1e-3 and abs(vals.std() - 0.5) < 1e-3
    short = tlarcv.LarcvDataset(files3d[0], "dunevoxels", max_voxels=10,
                                normalize=False, native=native)
    img = short.batch([0])["image"][0]
    assert img.shape == (10, 4) and np.all(img[:, 3] != -999.0)
    ds.close()
    short.close()


def test_softmax_h5_has_the_jax_layout(tmp_path):
    rng = np.random.default_rng(0)
    scores = {k: rng.random((6, n)).astype(np.float32) for k, n in OUTPUT_SHAPE.items()}
    write_softmax(tmp_path / "out.h5", scores)
    with h5py.File(tmp_path / "out.h5", "r") as f:
        assert sorted(f["Data"]) == sorted(f"softmax_{k}_group" for k in OUTPUT_SHAPE)
        for k, v in scores.items():
            assert list(f[f"Data/softmax_{k}_group"]) == ["scores"]
            np.testing.assert_array_equal(f[f"Data/softmax_{k}_group/scores"][:], v)
    write_softmax(tmp_path / "out.npz", scores)
    saved = np.load(tmp_path / "out.npz")
    assert all(np.array_equal(saved[k], v) for k, v in scores.items())
