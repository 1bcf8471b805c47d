"""The port's tools (sparseeventid_tpu_torch/scripts/) against the JAX
package's bin/ and scripts/ on the same inputs: the sparse-vs-dense
sweep's cases and sparse outputs at a small size, its CSV columns and its
need of a card, and every data tool's output file or printed lines on the
same input file."""

import csv
import importlib.util
import json
import runpy
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.io import larcv as tlarcv
from sparseeventid_tpu_torch.ops import build_sparse_tensor
from sparseeventid_tpu_torch.ops.engine import (
    WINDOW,
    XLA,
    apply_submanifold,
    plan_overflow_dropped,
)
from sparseeventid_tpu_torch.ops.window.engine import (
    build_submanifold_window_plan,
)
from sparseeventid_tpu_torch.ops.window.query import WindowTuning
from sparseeventid_tpu_torch.scripts import (
    calculate_weights,
    file_merge,
    file_premerge,
    make_dune3d_file,
    preprocess_fullres_2d,
    preprocess_fullres_3d,
    sparse_efficiency,
    voxel_occupancy,
)
from test_preprocess import _write_raw, _write_raw_2d

ROOT = Path(__file__).resolve().parents[1]
# the sweep at a small size: plain 16^2 and 16^3 grids, a capacity of 1024
# (the densest 3D row fills it), sites from 8 up to 1024
SWEEP = dict(sparsities=np.array([1e-2, 0.1, 0.3]), size=16, cap=1024)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX tool's sweep on the CPU (its ``xla`` backend), with its
    timing replaced by one call that records the arguments and the output:
    -> (rows, the COO it built per case, (args, output) per timed call)."""
    import sparseeventid_tpu.ops as jops

    mod = _load("bin/sparse_efficiency.py", "jax_sparse_efficiency")
    built, calls = [], []
    real_build = jops.build_sparse_tensor

    def build(coords, feats, grid, *args, **kwargs):
        built.append((np.asarray(coords), np.asarray(feats), tuple(grid)))
        return real_build(coords, feats, grid, *args, **kwargs)

    def time_fn(fn, *args, iters=5):
        out = fn(*args)
        calls.append(([np.asarray(a) for a in args if hasattr(a, "shape")],
                      np.asarray(out)))
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "build_sparse_tensor", build)
        mp.setattr(mod, "time_fn", time_fn)
        rows = mod.sweep(**SWEEP)
    return rows, built, calls


def test_sweep_cases_are_jax_cases(jax_sweep):
    """Per row: the same site count, sites, features and weights, drawn in
    the JAX tool's order."""
    rows, built, calls = jax_sweep
    cases = list(sparse_efficiency.cases(**SWEEP))
    assert len(cases) == len(built) == 6
    assert len(rows) == 18 and len(calls) == 36
    r = 0
    for case, (cpad, feats, grid) in zip(cases, built):
        n = case.n
        assert case.grid == grid
        np.testing.assert_array_equal(cpad[0, :n], case.coords)
        assert (cpad[0, n:] == -1).all()
        np.testing.assert_array_equal(feats[0, :n], case.feats)
        assert not feats[0, n:].any()
        for k, w, wd in case.weights:
            row = rows[r]
            assert (row["dim"], row["kernel"], row["nnz"]) == (case.dim, k, n)
            assert row["sparsity"] == case.sparsity
            (sparse_args, _), (dense_args, _) = calls[2 * r], calls[2 * r + 1]
            np.testing.assert_array_equal(sparse_args[-1], w)
            np.testing.assert_array_equal(dense_args[-1], wd)
            r += 1


@pytest.mark.parametrize("backend", [XLA, WINDOW])
def test_sweep_outputs_match_jax(jax_sweep, backend):
    """Every row's sparse output equals the JAX tool's within 1e-5, through
    the rulebook backend and the window backend (the kernels' plain
    versions on the CPU), with no pair dropped."""
    _, _, calls = jax_sweep
    runs = []
    rows = sparse_efficiency.sweep(
        **SWEEP, device="cpu", backend=backend, iters=1,
        on_row=lambda row, run: runs.append(run))
    assert len(rows) == len(runs) == 18
    for i, (row, run) in enumerate(zip(rows, runs)):
        assert row["dropped"] == 0
        np.testing.assert_allclose(run.out.numpy(), calls[2 * i][1],
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"row {i}: {row}")


def test_sweep_plans_keep_every_overflow_pair():
    """The tool's window plans list every candidate their sites can give.
    A sparse plane beside a dense one spreads a tile's +x neighbours over
    about 1024 table rows, far past a 160-row window: thousands of pairs
    go to the list, none is dropped and the conv equals the rulebook's,
    while a list half as long as the walked prefix drops pairs."""
    grid, cap = (4, 64, 64), 8192
    y, z = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    plane = np.stack([y.ravel(), z.ravel()], -1)
    sparse = plane[plane[:, 1] % 8 == 0]
    pts = np.concatenate([np.c_[np.zeros(len(sparse)), sparse],
                          np.c_[np.ones(len(plane)), plane]]).astype(np.int32)
    rng = np.random.default_rng(0)
    coords = np.full((1, cap, 3), -1, np.int32)
    coords[0, :len(pts)] = pts
    feats = np.zeros((1, cap, 8), np.float32)
    feats[0, :len(pts)] = rng.standard_normal((len(pts), 8))
    st = build_sparse_tensor(torch.from_numpy(coords), torch.from_numpy(feats),
                             grid)
    w = torch.from_numpy(rng.standard_normal((27, 8, 8)).astype(np.float32))
    plan = sparse_efficiency.build_plan(st, (3, 3, 3), WINDOW)
    occ = sparse_efficiency.list_occupancy(plan)
    assert occ["list_width"] == len(pts) * 27
    assert occ["real_pairs"] > 1000
    assert int(plan_overflow_dropped(plan)) == 0
    rulebook = sparse_efficiency.build_plan(st, (3, 3, 3), XLA)
    np.testing.assert_allclose(
        apply_submanifold(st, plan, w).feats.numpy(),
        apply_submanifold(st, rulebook, w).feats.numpy(), rtol=1e-5, atol=1e-5)
    narrow = build_submanifold_window_plan(
        st, (3, 3, 3), window_r=WindowTuning().window_r,
        overflow_cap=occ["walked"] // 2)
    assert int(plan_overflow_dropped(narrow)) > 0


def test_sweep_csv_has_the_jax_columns(jax_sweep, tmp_path):
    jax_rows = jax_sweep[0]
    rows = [dict(r, sparse_ms=1.0, dense_ms=2.0, speedup=2.0, dropped=0)
            for r in jax_rows]
    out = tmp_path / "sweep.csv"
    sparse_efficiency.write_csv(rows, out)
    with open(out, newline="") as f:
        header, *body = list(csv.reader(f))
    # the JAX tool's columns in its order, then the dropped pairs
    assert header == list(jax_rows[0]) + ["dropped"]
    assert len(body) == len(jax_rows)
    assert [int(b[3]) for b in body] == [r["nnz"] for r in jax_rows]


def test_sweep_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_efficiency.sweep()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_efficiency.main(["--size", "16"])
    rows = sparse_efficiency.sweep(dims=(2,), kernels=(3,), sparsities=[0.1],
                                   size=8, cap=64, device="cpu", iters=1)
    assert [r["nnz"] for r in rows] == [8]


# --------------------------------------------------------------------------
# the data tools: the JAX script and the port's tool on the same file
# --------------------------------------------------------------------------

def _run_jax(rel, args, monkeypatch, capsys) -> str:
    """A JAX script's main() with ``args`` -> what it printed."""
    mod = _load(rel, "jax_" + Path(rel).stem)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [rel, *map(str, args)])
    mod.main()
    return capsys.readouterr().out


def _run_port(mod, args, capsys) -> str:
    capsys.readouterr()
    assert mod.main([str(a) for a in args]) == 0
    return capsys.readouterr().out


def _assert_same_h5(a, b):
    """Two HDF5 files hold the same groups, datasets (dtype and bytes) and
    attributes."""
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        names, other = [], []
        fa.visit(names.append)
        fb.visit(other.append)
        assert names == other
        for n in names:
            assert dict(fa[n].attrs) == dict(fb[n].attrs), n
            if isinstance(fa[n], h5py.Dataset):
                assert fa[n].dtype == fb[n].dtype, n
                assert fa[n][()].tobytes() == fb[n][()].tobytes(), n


def _raw_events_3d(seed=0, n_events=6):
    """Events over every branch of the thresholds and labels: kept and
    dropped by the voxel count, each neutrino class, clamped protons,
    pions at and above their thresholds."""
    r = np.random.default_rng(seed)
    particles = [
        [(13, 0.5), (2212, 0.03), (211, 0.02)],
        [(13, 0.5)],
        [(11, 0.4), (2212, 0.03), (2212, 0.05), (2212, 0.021), (111, 0.001)],
        [(2212, 0.001), (22, 0.1), (211, 0.010), (-211, 0.011)],
        [(-11, 0.2), (2212, 0.020), (111, 0.0)],
        [(-13, 0.0), (14, 0.3), (2212, 0.5)],
    ]
    events = []
    for i in range(n_events):
        n = int(r.integers(30, 120))
        ids = np.sort(r.choice(1024 * 512 * 1280, n, replace=False))
        vals = r.uniform(0.0, 0.4, n).astype(np.float32)
        events.append((ids.astype(np.uint64), vals, particles[i % 6]))
    return events


def test_preprocess_3d_matches_jax(tmp_path, monkeypatch, capsys):
    raw = tmp_path / "raw.h5"
    _write_raw(raw, _raw_events_3d())
    outs = {}
    for who in ("jax", "port"):
        out = tmp_path / f"{who}.h5"
        args = [raw, out, "--producer", "sbndvoxels"]
        printed = (_run_jax("scripts/preprocess_fullres_3d.py", args,
                            monkeypatch, capsys) if who == "jax"
                   else _run_port(preprocess_fullres_3d, args, capsys))
        info = json.loads(printed.strip().splitlines()[-1])
        assert info.pop("output") == str(out)
        outs[who] = (out, info)
    assert outs["jax"][1] == outs["port"][1]
    assert outs["port"][1]["kept"] > 0 and outs["port"][1]["dropped_empty"] > 0
    _assert_same_h5(outs["jax"][0], outs["port"][0])


def test_preprocess_2d_matches_jax(tmp_path, monkeypatch, capsys):
    r = np.random.default_rng(3)
    in_rows, in_cols = 2304, 1024  # taller than the output: rows cut off
    events = []
    # (particles, largest value): the second event falls below the
    # threshold; the last one has two planes
    for i, (plist, top) in enumerate([([(13, 0.5), (2212, 0.03)], 0.05),
                                      ([(11, 0.1)], 0.012),
                                      ([(2212, 0.2), (111, 0.01)], 0.05),
                                      ([(13, 0.2)], 0.05)]):
        planes = []
        for _ in range(3 if i != 3 else 2):
            n = int(r.integers(5, 40))
            ids = np.sort(r.choice(in_rows * in_cols, n, replace=False))
            planes.append((ids.astype(np.uint64),
                           r.uniform(0.0, top, n).astype(np.float32)))
        events.append((planes, plist))
    raw = tmp_path / "raw2d.h5"
    _write_raw_2d(raw, events)
    outs = {}
    for who in ("jax", "port"):
        out = tmp_path / f"{who}.h5"
        args = [raw, out, "--input-rows", in_rows, "--input-cols", in_cols]
        printed = (_run_jax("scripts/preprocess_fullres_2d.py", args,
                            monkeypatch, capsys) if who == "jax"
                   else _run_port(preprocess_fullres_2d, args, capsys))
        info = json.loads(printed.strip().splitlines()[-1])
        assert info.pop("output") == str(out)
        outs[who] = (out, info)
    assert outs["jax"][1] == outs["port"][1]
    assert outs["port"][1]["kept"] > 0 and outs["port"][1]["dropped_empty"] > 0
    _assert_same_h5(outs["jax"][0], outs["port"][0])


@pytest.fixture(scope="module")
def larcv_inputs(tmp_path_factory):
    """Three small labelled larcv files of different seeds and sizes."""
    d = tmp_path_factory.mktemp("tool_inputs")
    return [tlarcv.write_synthetic_larcv_file(
        d / f"in{i}.h5", n_events=4 + i, image_size=(24, 24, 24), seed=i,
        max_voxels=256) for i in range(3)]


def test_file_merge_matches_jax(tmp_path, larcv_inputs, monkeypatch, capsys):
    printed = {}
    for who in ("jax", "port"):
        args = [tmp_path / who, *larcv_inputs, "--train-fraction", 0.7,
                "--seed", 5]
        printed[who] = (_run_jax("scripts/file_merge.py", args, monkeypatch,
                                 capsys) if who == "jax"
                        else _run_port(file_merge, args, capsys))
        printed[who] = printed[who].replace(str(tmp_path / who), "OUT")
    assert printed["jax"] == printed["port"]
    assert "train: 10 events" in printed["port"]
    for split in ("train", "test"):
        _assert_same_h5(tmp_path / "jax" / f"{split}.h5",
                        tmp_path / "port" / f"{split}.h5")


def test_file_premerge_matches_jax(tmp_path, larcv_inputs, monkeypatch,
                                   capsys):
    printed = {}
    for who in ("jax", "port"):
        args = [tmp_path / who / "pre", *larcv_inputs, "--chunk-size", 2]
        (tmp_path / who).mkdir()
        printed[who] = (_run_jax("scripts/file_premerge.py", args, monkeypatch,
                                 capsys) if who == "jax"
                        else _run_port(file_premerge, args, capsys))
        printed[who] = printed[who].replace(str(tmp_path / who), "OUT")
    assert printed["jax"] == printed["port"]
    for i in range(2):  # 3 files in chunks of 2
        _assert_same_h5(tmp_path / "jax" / f"pre_chunk2_{i}.h5",
                        tmp_path / "port" / f"pre_chunk2_{i}.h5")
    assert not (tmp_path / "port" / "pre_chunk2_2.h5").exists()


@pytest.mark.parametrize("tool", ["calculate_weights", "voxel_occupancy"])
def test_file_statistics_match_jax(tool, larcv_inputs, monkeypatch, capsys):
    port = {"calculate_weights": calculate_weights,
            "voxel_occupancy": voxel_occupancy}[tool]
    for path in larcv_inputs:
        want = _run_jax(f"scripts/{tool}.py", [path], monkeypatch, capsys)
        got = _run_port(port, [path], capsys)
        assert got.splitlines() == want.splitlines()
        assert len(got.splitlines()) > 2


def test_make_dune3d_file_matches_jax(tmp_path, monkeypatch, capsys):
    """Two events at the dune3d occupancy on the full grid, seed 1234."""
    jax_out, port_out = tmp_path / "jax.h5", tmp_path / "port.h5"
    monkeypatch.setattr(sys, "argv",
                        ["make_dune3d_file.py", str(jax_out), "2"])
    runpy.run_path(str(ROOT / "scripts/make_dune3d_file.py"))
    printed = _run_port(make_dune3d_file, [port_out, 2], capsys)
    assert printed.startswith(f"wrote 2 events to {port_out}")
    _assert_same_h5(jax_out, port_out)
    with h5py.File(port_out, "r") as f:
        ext = f["Data/sparse3d_dunevoxels_group/voxel_extents"][:]
    assert (ext["n"] > 5000).all()
