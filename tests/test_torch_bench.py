"""The port's benchmark drivers (sparseeventid_tpu_torch/scripts/bench*.py)
against the JAX drivers of the repository root on the same numpy inputs:
the useful-MAC count, the batch generators of both regimes, the straggler
filter, the in-memory events against a larcv file the JAX writer wrote
(the convergence run's dune3d events among them),
the single-plane dune2d classifier against flax, each driver's ``main`` on
the CPU at a tiny size (its JSON keys against the JAX driver's source),
and the bf16 peak table."""

import ast
import dataclasses
import importlib.util
import json
import tempfile
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset as JDataset
from sparseeventid_tpu.io import SyntheticEventConfig as JEventConfig
from sparseeventid_tpu.io.larcv import write_synthetic_larcv_file as jwrite
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_2d as jbatch2d
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.larcv import LarcvDataset
from sparseeventid_tpu_torch.io.memory import (
    SyntheticFileSpec,
    synthetic_larcv_dataset,
)
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_2d as tbatch2d
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.scripts import (
    accuracy_run,
    bench,
    bench_e2e,
    bench_extra,
)

ROOT = Path(__file__).resolve().parents[1]
# a small sparse model for the drivers' CPU runs; every level holds 1024
# sites, so no site is dropped on the tiny grids
SMALL = ("encoder.depth=2", "encoder.blocks_per_layer=1",
         "encoder.n_initial_filters=8", "head.hidden=32",
         "framework.min_capacity=1024", "data.max_voxels=1024")
TINY_RUN = ["--device", "cpu", "--warmup", "1", "--iters", "1", "--blocks",
            "1"]


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jbench():
    """The JAX ``bench.py`` (it imports no JAX at module level), at batch 2."""
    mod = _load("bench.py", "jax_bench")
    mod.BATCH = 2
    return mod


def _jax_keys(rel: str, function: str):
    """The string keys of every dict literal in ``function`` of a JAX
    driver's source, and those it assigns (``out["key"] = ...``)."""
    tree = ast.parse((ROOT / rel).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = {k.value for n in ast.walk(fn) if isinstance(n, ast.Dict)
            for k in n.keys if isinstance(k, ast.Constant)}
    return keys | {t.slice.value for n in ast.walk(fn)
                   if isinstance(n, ast.Assign) for t in n.targets
                   if isinstance(t, ast.Subscript)
                   and isinstance(t.slice, ast.Constant)}


def _keys(obj):
    """Every key of a JSON object, nested objects' included."""
    out = set()
    for k, v in obj.items():
        out.add(k)
        if isinstance(v, dict):
            out |= _keys(v)
    return out


# ---- bench.py: MACs, batches, the straggler filter, the peak table


def test_useful_macs_equal_the_jax_count(jbench):
    """2 events of the 25k generator cut to 3000 voxels, on the dune3d
    grid: the port's count equals bench.py's as an integer."""
    st, _, _ = jbench.make_batch(jbench.ACTIVE_VOXELS, 40)
    coords = np.asarray(st.coords)[:, :3000]
    assert (coords[:, :, 0] >= 0).sum() == 6000
    want = jbench.useful_macs_per_train_step(coords, jload("dune3d"))
    got = bench.useful_macs_per_train_step(coords, tload("dune3d"), bench.GRID)
    assert isinstance(got, int) and got == want > 0


@pytest.mark.parametrize("n_tracks", [40, None], ids=["25k", "36k"])
def test_make_batch_equals_jax(jbench, n_tracks):
    """Both routes at batch 2: the same sorted coordinates, bf16 values,
    labels and mean occupancy as bench.py's ``make_batch``."""
    sj, lj, occ_j = jbench.make_batch(bench.ACTIVE_VOXELS, n_tracks)
    st, labels, occ = bench.make_batch(bench.ACTIVE_VOXELS, n_tracks, batch=2)
    assert occ == occ_j > (20000 if n_tracks is None else 10000)
    np.testing.assert_array_equal(st.coords.numpy(), np.asarray(sj.coords))
    np.testing.assert_array_equal(st.feats.float().numpy(),
                                  np.asarray(sj.feats, np.float32))
    assert st.feats.dtype == torch.bfloat16
    assert labels.keys() == lj.keys() == OUTPUT_SHAPE.keys()
    for k in OUTPUT_SHAPE:
        np.testing.assert_array_equal(labels[k].numpy(), np.asarray(lj[k]))


def _blocks_of(rates):
    it = iter(rates)
    return lambda: next(it)


def test_straggler_filter_on_the_repositorys_blocks():
    """BENCH_r05.json's blocks: the first is a straggler, the sixth block
    makes five kept, median 29.35."""
    blocks = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]["blocks"]
    assert blocks == [5.66, 29.35, 29.32, 29.31, 29.41, 29.39]
    rates, kept = bench.timed_blocks(_blocks_of(blocks), 5, 3)
    assert rates == blocks and len(kept) == 5
    assert float(np.median(kept)) == 29.35


@pytest.mark.parametrize("seq,n_run,n_kept", [
    ([5.0, 5.0, 30.0, 30.0, 30.0, 30.0, 30.0, 30.0], 7, 5),  # two extras
    ([30.0] * 4 + [1.0] * 4, 8, 4),  # every extra block, still short
    ([30.0, 31.0, 29.0, 30.5, 29.5, 1.0], 5, 5),  # steady: no extra block
])
def test_straggler_filter_takes_extra_blocks(seq, n_run, n_kept):
    rates, kept = bench.timed_blocks(_blocks_of(seq), 5, 3)
    assert rates == seq[:n_run] and len(kept) == n_kept
    assert kept == bench.kept_blocks(rates)
    assert min(kept) >= 0.85 * float(np.median(rates))


class _Metric:
    """A dropped count that records whether the host read it."""

    def __init__(self, n, log):
        self.n, self.log = n, log

    def __add__(self, other):
        n = other.n if isinstance(other, _Metric) else other
        return _Metric(self.n + n, self.log)

    __radd__ = __add__

    def __int__(self):
        self.log.append("read")
        return self.n


def test_steps_read_dropped_pairs_only_at_the_fence():
    """``Steps`` queues steps without reading their metrics (no wait for
    the card between steps); ``fence`` reads the sum of every step's
    dropped pairs, as the JAX drivers' fence once a block."""
    log = []

    def step(x, i):
        log.append(("step", x, i))
        return {"overflow/dropped": _Metric(i % 2, log)}

    steps = bench.Steps(step, torch.device("cpu"))
    rate = bench.timed_rate(lambda: steps("a"), 4, 8, steps.fence)
    assert rate > 0 and steps.taken == 4 and steps.dropped == 2
    assert log == [("step", "a", i) for i in range(4)] + ["read"]
    steps("b")
    assert steps.dropped == 2
    steps.fence()
    assert steps.dropped == 2 and log[-2:] == [("step", "b", 4), "read"]


def test_peak_table_is_the_cards_own():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3", 500.0) == 500.0
    assert bench.peak_tflops("Some Card", 312.0) == 312.0
    with pytest.raises(ValueError, match="--peak-tflops"):
        bench.peak_tflops("Some Card")
    with pytest.raises(ValueError, match="--peak-tflops"):
        bench.peak_tflops("cpu")
    # a CPU run has no card peak: it needs the flag before it trains
    with pytest.raises(ValueError, match="--peak-tflops"):
        bench.main(["--device", "cpu"])


# ---- the in-memory events against a file the JAX writer wrote


SPEC_3D = SyntheticFileSpec(4, (64, 32, 48), seed=77, dimension=3,
                            mean_tracks=4.0, steps_per_track=60,
                            max_voxels=700)
# bench_extra.py's dune2d arguments, cut to a 64 x 32 plane
SPEC_2D = SyntheticFileSpec(4, (3, 64, 32), seed=77, dimension=2,
                            mean_tracks=4.0, steps_per_track=60,
                            max_voxels=700)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# the first 3 events of the convergence run's dune3d files
# (scripts/accuracy_run.py's, sparseeventid_tpu_torch.scripts.accuracy_run's
# DUNE3D_TRAIN and DUNE3D_VAL), read whole
ACC_TRAIN_3 = dataclasses.replace(accuracy_run.DUNE3D_TRAIN, n_events=3)
ACC_VAL_3 = dataclasses.replace(accuracy_run.DUNE3D_VAL, n_events=3)


@pytest.mark.parametrize("spec,max_voxels", [
    (SPEC_3D, 500), (SPEC_2D, 500), (ACC_TRAIN_3, 50000), (ACC_VAL_3, 50000),
], ids=["3d", "2d", "acc_dune3d_train", "acc_dune3d_val"])
def test_memory_events_equal_a_jax_written_file(spec, max_voxels, tmp_path):
    path = tmp_path / "jax.h5"
    jwrite(path, **{k: v for k, v in dataclasses.asdict(spec).items()
                    if k != "planes"})
    f = LarcvDataset(path, "dunevoxels", dimension=spec.dimension,
                     max_voxels=max_voxels)
    m = synthetic_larcv_dataset(spec, max_voxels=max_voxels)
    n = spec.n_events
    try:
        assert len(m) == len(f) == n and m.read_route == "memory"
        assert m.image_size() == f.image_size() == m.batch_grid()
        for idx in ([n - 2, 0, n - 1], [1]):
            got, want = m.batch(idx), f.batch(idx)
            assert {"image", "index", "energy", "vertex",
                    *OUTPUT_SHAPE} == set(want)
            _assert_batches_equal(got, want)
        image = want["image"]
    finally:
        f.close()
    live = (image[..., -1] != -999).sum()
    assert live > 10
    if spec.dimension == 2:
        # the JAX writer's 2D layout: one projection of 3-D ids, whose
        # pixels keep the padding in the 2D value column -> no valid pixel
        assert image.shape[1] == 1 and (image[..., 2] != -999).sum() == 0


def test_plane_events_are_the_synthetic_2d_projections(tmp_path):
    """``planes=True``: the port's file and its memory events agree, and
    each plane's pixels and summed charge are the JAX synthetic 2D split's
    projection of the same event, on (H, H, W), inside the plane."""
    spec = dataclasses.replace(SPEC_2D, planes=True, max_voxels=5000)
    path = spec.write(tmp_path / "planes.h5")
    f = LarcvDataset(path, "dunevoxels", dimension=2, max_voxels=2000,
                     normalize=False)
    m = synthetic_larcv_dataset(spec, max_voxels=2000, normalize=False)
    got = m.batch([0, 1, 2, 3])
    _assert_batches_equal(got, f.batch([0, 1, 2, 3]))
    f.close()
    assert m.image_size() == (3, 64, 32)
    jds = JDataset(4, JEventConfig(image_size=(64, 64, 32), n_planes=3,
                                   max_voxels=5000, normalize=False,
                                   mean_tracks=4.0, steps_per_track=60),
                   seed=77)
    want = jds.batch([0, 1, 2, 3])["image"]
    for b in range(4):
        for p in range(3):
            w = want[b, p]
            w = w[(w[:, 2] != -999) & (w[:, 0] < 32) & (w[:, 1] < 64)]
            g = got["image"][b, p]
            g = g[g[:, 2] != -999]
            assert len(w) > 0
            np.testing.assert_array_equal(g, w)


# ---- the single-plane dune2d classifier (bench_extra's dune2d_singleplane)


PLANE_GRID = (1, 32, 32)
PLANE_CAP = 1024
PLANE_OVERRIDES = [
    "data.dimension=2", "data.images=1", "encoder.depth=2",
    "encoder.blocks_per_layer=1", "encoder.n_initial_filters=4",
    "encoder.n_output_filters=8", "run.minibatch_size=2",
    "framework.min_capacity=64", "head.dropout=0.0", "head.hidden=16",
]


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_single_plane_logits_match_flax(backend):
    """One plane of 32 x 32 pixels (``data.images=1``): the port on either
    backend against the flax model on its plain backend, from the same
    variables, with the cross-plane merge at its default and at depth 1."""
    image = synthetic_larcv_dataset(
        SyntheticFileSpec(2, (1, 32, 32), seed=5, dimension=2,
                          mean_tracks=3.0, steps_per_track=80,
                          max_voxels=2000, planes=True),
        max_voxels=256).batch([0, 1])["image"]
    assert image.shape == (2, 1, 256, 3) and (image[..., 2] != -999).sum() > 100
    sj = jbatch2d(image, PLANE_GRID, capacity=PLANE_CAP)
    st = tbatch2d(image, PLANE_GRID, capacity=PLANE_CAP)
    for merge in (-1, 1):
        extra = [f"encoder.plane_merge_depth={merge}"]
        cfgs = []
        for load, be in ((jload, "xla"), (tload, backend)):
            cfg = load("synthetic", PLANE_OVERRIDES + extra
                       + [f"framework.sparse_backend={be}"])
            cfgs.append(dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, max_voxels=256)))
        v = jbuild(cfgs[0]).init(jax.random.PRNGKey(0), sj, True)
        rng = np.random.default_rng(4)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.uniform(0.5, 1.5, x.shape)
                             if path[-1].key == "var"
                             else rng.normal(0.0, 0.2, x.shape)
                             ).astype(np.float32),
            flax.core.unfreeze(v["batch_stats"]))
        params = jax.tree_util.tree_map(np.asarray,
                                        flax.core.unfreeze(v["params"]))
        want = jbuild(cfgs[0]).apply({"params": params, "batch_stats": stats},
                                     sj, False)
        model = tbuild(cfgs[1])
        model.load_state_dict(params_from_jax(params, stats))
        model.eval()
        with torch.no_grad():
            got, dropped = model(st)
        assert int(dropped) == 0
        for k in OUTPUT_SHAPE:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4)


# ---- each driver's main on the CPU at a tiny size


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return [json.loads(ln) for ln in lines]


BENCH_ADDED = {"device", "power_limit_w", "peak_tflops", "warmup",
               "plans_widened"}


def test_bench_main_on_the_cpu(monkeypatch, capsys, one_torch_thread):
    monkeypatch.setattr(bench, "GRID", (64, 64, 64))
    monkeypatch.setattr(bench, "MAX_VOXELS", 1024)
    monkeypatch.setattr(bench, "ACTIVE_VOXELS", 800)
    monkeypatch.setattr(bench, "OVERRIDES", SMALL)
    # a query bound of 0.5 of the capacity is sized for 50k-voxel rows; a
    # 1024-row batch of 766 sites needs the whole capacity
    out = bench.main(["--device", "cpu", "--peak-tflops", "1.0",
                      "--qbound-frac", "1.0", "--warmup", "1", "--iters",
                      "1", "--blocks", "1", "--extra-blocks", "0"])
    assert _last_json(capsys) == [out]
    # the JAX keys but its failure note ("error"; a failure raises here)
    want = _jax_keys("bench.py", "main") - {"error"}
    assert want <= _keys(out) and _keys(out) - want == BENCH_ADDED
    for r in (out, out["regime_36k"]):
        assert r["overflow_dropped"] == 0 and r["blocks_kept"] == 1
        assert len(r["blocks"]) == 1 and r["blocks"][0] > 0
    assert out["config"]["host_plans"] and out["config"]["grid"] == [64, 64, 64]
    assert 0 < out["mfu_useful"] and out["peak_tflops"] == 1.0
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["config"]["occupancy_measured"] > 500


E2E_ADDED = {"data", "device", "power_limit_w", "plans_widened"}


@pytest.mark.parametrize("route", ["larcv", "memory"])
def test_bench_e2e_main_on_the_cpu(route, monkeypatch, capsys, tmp_path,
                                   one_torch_thread):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench_e2e, "data_route", lambda: route)
    monkeypatch.setattr(bench_e2e, "OVERRIDES", SMALL)
    for name, value in (("BATCH", 2), ("DEVICE_WARMUP", 1),
                        ("DEVICE_BLOCKS", 1), ("DEVICE_ITERS", 1)):
        monkeypatch.setattr(bench_e2e, name, value)
    monkeypatch.setattr(bench_e2e, "SPEC", dict(
        image_size=(64, 64, 64), seed=77, mean_tracks=4.0,
        steps_per_track=60, max_voxels=1024))
    repo_json = (ROOT / "BENCH_e2e.json").read_bytes()
    dest = tmp_path / "e2e" / "out.json"
    out = bench_e2e.main(["--device", "cpu", "--events", "4",
                          "--warm-epochs", "1", "--out", str(dest)])
    assert _last_json(capsys) == [out]
    assert json.loads(dest.read_text()) == out
    assert (ROOT / "BENCH_e2e.json").read_bytes() == repo_json
    want = _jax_keys("bench_e2e.py", "main")
    assert want <= _keys(out) and _keys(out) - want == E2E_ADDED
    assert out["overflow_dropped"] == 0 and out["data"] == route
    assert out["plans_widened"] == 0 and out["occupancy_vox_per_event"] > 50
    assert len(out["warm_epoch_blocks"]) == len(out["device_only_blocks"]) == 1
    assert min(out["cold_epoch_ev_s"], out["warm_epoch_ev_s"],
               out["device_only_ev_s"], out["host_plan_ms_per_batch"]) > 0
    assert list(tmp_path.glob("dune3d_e2e_*.h5")) == (
        [] if route == "memory" else list(tmp_path.glob("*.h5")))


EXTRA_ADDED = {"data", "device", "power_limit_w", "plans_widened", "deviation"}
POINTS = ("encoder.max_points=64", "data.max_voxels=1024")


@pytest.mark.parametrize("name", list(bench_extra.CONFIGS))
def test_bench_extra_main_on_the_cpu(name, monkeypatch, capsys, tmp_path,
                                     one_torch_thread):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for key, spec in bench_extra.FILES.items():
        size = ((spec.image_size[0], 48, 32) if spec.dimension == 2
                else (64, 64, 64))
        monkeypatch.setitem(bench_extra.FILES, key, dataclasses.replace(
            spec, n_events=6, image_size=size, mean_tracks=4.0,
            steps_per_track=60, max_voxels=1024))
    monkeypatch.setattr(bench_extra, "BATCH", 2)
    monkeypatch.setattr(bench_extra, "OVERRIDES",
                        POINTS if name in ("pointnet", "dgcnn")
                        else SMALL + ("data.aug_max_voxels=256",))
    outs = bench_extra.main([name, *TINY_RUN])
    printed = _last_json(capsys)
    assert printed[-1:] == outs and len(outs) == 1
    out = outs[0]
    want = _jax_keys("bench_extra.py", "bench_one")
    assert want <= _keys(out) and _keys(out) - want == EXTRA_ADDED
    assert out["metric"] == f"{name}_train_events_per_sec_per_chip"
    assert out["overflow_dropped"] == 0 and out["value"] > 0
    assert out["config"]["overrides"][:len(bench_extra.CONFIGS[name][1])] == \
        bench_extra.CONFIGS[name][1]
    assert out["data"] == "larcv"  # h5py imports here
    if name == "simclr":
        assert printed[0] == {"simclr_default_capacities": True,
                              "overflow_dropped": 0.0}
        assert "framework.capacity_shrink=0.75" in out["config"]["overrides"]
    sparse = name not in ("pointnet", "dgcnn", "simclr")
    assert (out["plans_widened"] is not None) == sparse


def test_bench_extra_refuses_unknown_configs():
    with pytest.raises(SystemExit):
        bench_extra.main(["nonesuch", "--device", "cpu"])
