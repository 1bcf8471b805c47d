"""The port's convergence run (sparseeventid_tpu_torch/scripts/
accuracy_run.py, acc_extend.py) against the repository's JAX scripts
(scripts/accuracy_run.py, acc_extend.py, acc_salvage.py): the presets'
configs, the first steps of a run from the same weights, the whole script
on the CPU at a tiny size, the binomial test on the JAX run's numbers and
the extension's report."""

import ast
import dataclasses
import importlib.util
import json
import re
import shutil
import sys
import tempfile
import types
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

import sparseeventid_tpu.config as jconfig
import sparseeventid_tpu.train.trainer as jtrainer
from sparseeventid_tpu.config.loader import config_to_dict as jdict
from sparseeventid_tpu.config.schema import DETECTOR_META as JMETA
from sparseeventid_tpu.config.schema import Detector as JDetector
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config.loader import config_to_dict as tdict
from sparseeventid_tpu_torch.config.schema import DETECTOR_META as TMETA
from sparseeventid_tpu_torch.config.schema import Detector as TDetector
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.scripts import acc_extend
from sparseeventid_tpu_torch.scripts import accuracy_run as acc
from sparseeventid_tpu_torch.scripts import grad_gap

ROOT = Path(__file__).resolve().parents[1]
# a tiny model for the CPU runs (every level holds all of an event's sites)
TINY = ("run.minibatch_size=2", "run.precision=float32", "encoder.depth=2",
        "encoder.blocks_per_layer=1", "encoder.n_initial_filters=8",
        "head.hidden=32", "data.max_voxels=256", "data.synthetic_events=16",
        "framework.min_capacity=256", "head.dropout=0.0")
# the port's config has no MXU layout switches (framework.tuning's
# fused_bwd, batched_sidecar, p_series) and names its own framework,
# distributed mode and device
PORT_ONLY = {("framework", "name"), ("framework", "distributed_mode"),
             ("run", "compute_mode")}
TPU_ONLY_TUNING = ("fused_bwd", "batched_sidecar", "p_series")


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel: str, name: str, monkeypatch, preset="small"):
    """A JAX script loaded by path; the acc_* scripts import
    ``accuracy_run`` through ``sys.path`` and set ``ACC_PRESET``, both
    undone after the test."""
    monkeypatch.setenv("ACC_PRESET", preset)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.delitem(sys.modules, "accuracy_run", raising=False)
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _comparable(d):
    """``config_to_dict`` without what the test leaves out: the data paths
    (the port's dune3d splits are files or memory by host), ``output_dir``
    (each run's own), and what only one package has (``PORT_ONLY``, the
    TPU layout switches)."""
    d = json.loads(json.dumps(d))
    d.pop("output_dir")
    for split in ("train", "val", "test"):
        d["data"].pop(split)
    for group, key in PORT_ONLY:
        d[group].pop(key)
    for key in TPU_ONLY_TUNING:
        d["framework"]["tuning"].pop(key, None)
    return d


class _Recorded(Exception):
    pass


def _jax_overrides(fn, monkeypatch):
    """The (recipe, overrides) that ``fn`` passes to the JAX
    ``load_config``; its ``Trainer`` is stubbed, so nothing is built."""
    seen = []

    def record(recipe, overrides):
        seen.append((recipe, list(overrides)))
        return jconfig.loader.load_config(recipe, overrides)

    def trainer(cfg):
        raise _Recorded

    monkeypatch.setattr(jconfig, "load_config", record)
    monkeypatch.setattr(jtrainer, "Trainer", trainer)
    with pytest.raises(_Recorded):
        fn()
    return seen[0]


def _port_ctx(preset, tmp_path):
    return acc.Context(preset, torch.device("cpu"), tmp_path,
                       route="memory" if preset == "dune3d" else "synthetic")


# ---- (a) the presets' configs


@pytest.mark.parametrize("preset", ["small", "dune3d"])
@pytest.mark.parametrize("backend", ["window", "xla"])
def test_preset_configs_equal_the_jax_scripts(preset, backend, monkeypatch,
                                              tmp_path):
    mod = _load("scripts/accuracy_run.py", "jax_accuracy_run", monkeypatch)
    mod.PRESET = preset
    monkeypatch.setattr(mod, "_ensure_dune3d_files", lambda: None)
    recipe_j, ov_j = _jax_overrides(
        lambda: mod.build_trainer(backend, "acc_window", 1500), monkeypatch)
    recipe_t, ov_t = acc.preset_overrides(_port_ctx(preset, tmp_path),
                                          backend, "acc_window", 1500)
    assert recipe_t == recipe_j
    want = _comparable(jdict(jconfig.loader.load_config(recipe_j, ov_j)))
    assert _comparable(tdict(tload(recipe_t, ov_t))) == want
    assert want["mode"]["iterations"] == 1500


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_compare_config_equals_acc_salvage(backend, monkeypatch, tmp_path):
    mod = _load("scripts/acc_salvage.py", "jax_acc_salvage", monkeypatch,
                preset="dune3d")
    monkeypatch.setattr(mod.acc, "_ensure_dune3d_files", lambda: None)
    recipe_j, ov_j = _jax_overrides(lambda: mod.run_compare(backend, 300),
                                    monkeypatch)
    recipe_t, ov_t = acc.preset_overrides(
        _port_ctx("dune3d", tmp_path), backend, "unused", 300, compare=True)
    assert recipe_t == recipe_j == "dune3d"
    want = _comparable(jdict(jconfig.loader.load_config(recipe_j, ov_j)))
    got = _comparable(tdict(tload(recipe_t, ov_t)))
    assert got == want
    assert got["run"]["minibatch_size"] == 4 and got["framework"]["remat"]


def test_plan_cache_fits_the_host(monkeypatch):
    monkeypatch.setattr(acc, "host_memory_mb", lambda: 96 * 1024)
    assert acc.plan_cache_budget() == acc.PLAN_CACHE_MB == 32768
    monkeypatch.setattr(acc, "host_memory_mb", lambda: 32 * 1024)
    assert acc.plan_cache_budget() == 16 * 1024


# ---- (c) the first steps against the JAX script's run_training


@pytest.fixture
def tiny_grid(monkeypatch):
    """The synthetic detector's grid cut to 32^3 in both packages."""
    for meta, det in ((JMETA, JDetector), (TMETA, TDetector)):
        monkeypatch.setitem(meta, det.synthetic, dict(
            meta[det.synthetic], image_size=(32, 32, 32),
            spatial=(32, 32, 32)))


def test_three_steps_follow_the_jax_run(monkeypatch, tmp_path, tiny_grid,
                                        one_torch_thread):
    """Three steps of the small preset cut to TINY, the ``xla`` backend on
    both sides, from the JAX run's initial weights: the step-0 train
    point, the step-0 validation point and the final sweep (the weights
    after three steps) within rtol 1e-3."""
    mod = _load("scripts/accuracy_run.py", "jax_accuracy_run", monkeypatch)
    real = jconfig.loader.load_config
    tiny = [*TINY, "framework.sparse_backend=xla"]
    monkeypatch.setattr(jconfig, "load_config", lambda recipe, ov: real(
        recipe, [*ov, *tiny, f"output_dir={tmp_path / 'jax'}"]))
    t = mod.build_trainer("xla", "acc_init", 3)
    state = t._build_training()[0]
    t._shutdown()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray,
                                                flax.core.unfreeze(tree))
    params = params_from_jax(to_np(state.params), to_np(state.batch_stats))
    tr_j, val_j, final_j, std_j = mod.run_training("xla", "acc_xla", 3)

    monkeypatch.setattr(acc, "OVERRIDES", tuple(tiny))
    got = acc.run_training(_port_ctx("small", tmp_path / "port"), "xla",
                           "acc_xla", 3, params=params)
    assert got.steps == 3 and got.dropped == 0
    assert len(got.train) == len(tr_j) == 1 and len(got.val) == len(val_j) == 1
    for mine, theirs in ((got.train[0], tr_j[0]), (got.val[0], val_j[0]),
                         (got.final, final_j)):
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    assert set(got.final_std) >= set(std_j)


# ---- (d) the whole script on the CPU


def _jax_json_keys():
    """The keywords of the ``dict(...)`` calls of the JAX script: its JSON's
    keys and those of its ``resume``."""
    tree = ast.parse((ROOT / "scripts" / "accuracy_run.py").read_text())
    return {kw.arg for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "id", None) == "dict" for kw in n.keywords}


def _sections(md: str):
    return [re.sub(r" \(.*", "", ln) for ln in md.splitlines()
            if ln.startswith("## ")]


def _tiny_script(monkeypatch, preset):
    monkeypatch.setattr(acc, "OVERRIDES", TINY)
    monkeypatch.setitem(acc.RESUME, preset, (4, 8))
    monkeypatch.setitem(acc.FINAL_BATCHES, preset, 2)
    monkeypatch.setattr(acc, "VAL_POINT_BATCHES", 1)
    monkeypatch.setattr(acc, "CURVE_EVERY", 2)
    monkeypatch.setitem(acc.VAL_EVERY, preset, 4)


def test_small_preset_script_on_the_cpu(monkeypatch, tmp_path, tiny_grid,
                                        one_torch_thread):
    _tiny_script(monkeypatch, "small")
    out = tmp_path / "ACC.md"
    doc = acc.main(["--device", "cpu", "--steps", "6", "--xla-steps", "4",
                    "--out", str(out), "--output-dir", str(tmp_path / "runs")])
    assert json.loads(out.with_suffix(".json").read_text()) == doc
    assert _jax_json_keys() <= set(doc) | set(doc["resume"])
    assert {"window_final_std", "n_val_events", "device"} <= set(doc)
    assert doc["resume"] == {"resumed_at": 4, "final_step": 8}
    assert doc["n_val_events"] == 2 * 8 and doc["device"]["name"] == "cpu"
    assert [m["step"] for m in doc["window_train"]] == [0, 2, 4]
    assert [m["step"] for m in doc["window_val"]] == [0, 4]
    assert [m["step"] for m in doc["xla_train"]] == [0, 2]
    for run in doc["runs"].values():
        assert run["dropped"] == 0 and run["steps"] > 0
    assert all(m["overflow/dropped"] == 0 for m in doc["window_train"])
    assert all(np.isfinite(m["loss/loss"]) for m in doc["window_train"])
    # the same weights and batch: step 0 of both backends agrees
    assert abs(doc["window_short_train"][0]["loss/loss"]
               - doc["xla_train"][0]["loss/loss"]) < 1e-4
    md = out.read_text()
    assert _sections((ROOT / "ACCURACY.md").read_text()) == [
        s for s in _sections(md) if not s.startswith("## Smoothed")]
    assert "(the JAX run: 0.0456)" in md and "z vs JAX" in md
    assert (tmp_path / "runs" / "synthetic" / "acc_window" / "checkpoints"
            / "step_6.pt").exists()


@pytest.fixture
def tiny_dune3d(monkeypatch):
    """The dune3d preset's events cut to 8 train and 4 val events on a
    64 x 32 x 48 grid."""
    spec = dict(image_size=(64, 32, 48), mean_tracks=4.0, steps_per_track=60,
                max_voxels=256)
    monkeypatch.setattr(acc, "DUNE3D_TRAIN", dataclasses.replace(
        acc.DUNE3D_TRAIN, n_events=8, **spec))
    monkeypatch.setattr(acc, "DUNE3D_VAL", dataclasses.replace(
        acc.DUNE3D_VAL, n_events=4, **spec))
    _tiny_script(monkeypatch, "dune3d")


@pytest.mark.parametrize("route", ["memory", "larcv"])
def test_dune3d_preset_script_on_the_cpu(route, monkeypatch, tmp_path,
                                         tiny_dune3d, one_torch_thread):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(acc, "data_route", lambda: route)
    out = tmp_path / "ACC_dune3d.md"
    doc = acc.main(["--preset", "dune3d", "--device", "cpu", "--steps", "4",
                    "--xla-steps", "2", "--xla-full", "--out", str(out),
                    "--output-dir", str(tmp_path / "runs")])
    assert doc["resume"] == {"resumed_at": 4, "final_step": 8}
    assert set(doc["runs"]) == {"acc_window", "acc_xla", "acc_window_short"}
    assert all(r["dropped"] == 0 for r in doc["runs"].values())
    # the comparison runs take batch 4 and validate on nothing
    assert doc["runs"]["acc_xla"]["eval_batches"] == 0
    assert len(doc["xla_train"]) == len(doc["window_short_train"]) == 1
    assert doc["plan_cache_mb"] == acc.plan_cache_budget()
    assert (tmp_path / "runs" / "dune3d" / "acc_cmp_xla").is_dir()
    files = sorted(p.name for p in tmp_path.glob("acc_dune3d_*.h5"))
    assert len(files) == (2 if route == "larcv" else 0)
    assert "## Val accuracy curve" in out.read_text()


def test_a_failed_phase_raises(monkeypatch, tmp_path, tiny_grid):
    _tiny_script(monkeypatch, "small")

    def broken(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(acc, "run_resume_check", broken)
    out = tmp_path / "ACC.md"
    with pytest.raises(RuntimeError, match="planted"):
        acc.main(["--device", "cpu", "--steps", "2", "--xla-steps", "2",
                  "--out", str(out), "--output-dir", str(tmp_path / "runs")])
    assert not out.exists()
    # what ran is in the JSON, written as the run went
    doc = json.loads(out.with_suffix(".json").read_text())
    assert doc["window_train"] and doc["xla_train"] and doc["resume"] == {}


def test_the_card_is_required():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        acc.main(["--steps", "1"])


# ---- the fp32 gradient gap (scripts/grad_gap.py)


def test_grad_gap_from_seeded_and_trained_weights(monkeypatch, tmp_path,
                                                   tiny_grid, one_torch_thread):
    """grad_gap's main at TINY from the seeded weights and from a
    checkpoint two steps on: the window path (its kernels' plain versions
    here) gives the xla backend's fp32 gradients to rounding."""
    monkeypatch.setattr(acc, "OVERRIDES", TINY)
    runs = tmp_path / "runs"
    acc.run_training(_port_ctx("small", runs), "window", "acc_window", 2)
    ckpt = runs / "synthetic" / "acc_window" / "checkpoints" / "step_2.pt"
    out = grad_gap.main(["--device", "cpu", "--events", "2", "--checkpoint",
                         str(ckpt), "--output-dir", str(runs)])
    assert out["events"] == 2 and out["device"]["name"] == "cpu"
    init, trained = out["init"], out["trained"]
    assert init["xla_loss"] != trained["xla_loss"]
    for gap in (init, trained):
        assert gap["tensors"] == len(gap["rel_l2"]) > 10
        assert not any(n.endswith(".b") for n in gap["rel_l2"])
        assert gap["worst_rel_l2"] == max(gap["rel_l2"].values()) < 1e-4
        np.testing.assert_allclose(gap["window_loss"], gap["xla_loss"],
                                   rtol=1e-5)


# ---- (e) the binomial test


def test_binomial_z_gives_the_dune3d_reports_sigmas():
    doc = json.loads((ROOT / "ACCURACY_dune3d.json").read_text())
    final = doc["final_val_3000"]
    got = {k: f"{acc.z_vs_chance(final[k], acc.CHANCE[k], 256):+.1f}"
           for k in acc.CHANCE}
    assert got == {"acc/labelcpiID": "+5.9", "acc/labelneutID": "+11.4",
                   "acc/labelnpiID": "+15.6", "acc/labelprotID": "+4.9"}
    # the constants are the JAX runs' own numbers
    means, n = acc.JAX_MEANS["dune3d"]
    assert n == 256 and all(means[k] == final[k] for k in means)
    table = (ROOT / "ACCURACY.md").read_text()
    means, n = acc.JAX_MEANS["small"]
    for k, p in means.items():
        assert f"| {k} | {p * 100:.1f}% |" in table
    assert acc.z_vs_reference(0.5, 128, 0.5, 256) == 0.0
    assert acc.z_vs_reference(0.6, 100, 0.5, 100) == pytest.approx(
        0.1 / np.sqrt(0.24 / 100 + 0.25 / 100))


# ---- (f) acc_extend


def test_extend_resumes_and_merges_the_curve(monkeypatch, tmp_path,
                                             tiny_dune3d, one_torch_thread):
    monkeypatch.setattr(acc, "data_route", lambda: "memory")
    out = tmp_path / "ACC_dune3d.md"
    runs = tmp_path / "runs"
    first = acc.main(["--preset", "dune3d", "--device", "cpu", "--steps", "4",
                      "--out", str(out), "--output-dir", str(runs)])
    assert [m["step"] for m in first["window_train"]] == [0, 2]
    monkeypatch.setattr(acc_extend, "SAVE_EVERY", 4)
    doc = acc_extend.main(["--steps", "8", "--out", str(out), "--output-dir",
                           str(runs), "--device", "cpu"])
    assert [m["step"] for m in doc["train_window"]] == [0, 2, 4, 6]
    assert doc["train_window"][:2] == first["window_train"]
    assert doc["final_val_step"] == 8 and doc["resume"] == [4, 8]
    assert json.loads(out.with_suffix(".json").read_text()) == doc
    ckpts = runs / "dune3d" / "acc_window" / "checkpoints"
    assert {p.name for p in ckpts.glob("step_*.pt")} >= {"step_4.pt",
                                                         "step_8.pt"}
    # a run with nothing to resume raises
    shutil.rmtree(ckpts)
    with pytest.raises(RuntimeError, match="nothing to extend"):
        acc_extend.main(["--steps", "8", "--out", str(out), "--output-dir",
                         str(runs), "--device", "cpu"])


def _report_lines(text: str):
    return [ln for ln in text.splitlines()
            if ln.startswith(("|", "step ", "Tail slope", "max |window"))]


def test_extend_report_equals_the_jax_tools(monkeypatch, tmp_path):
    mod = _load("scripts/acc_extend.py", "jax_acc_extend", monkeypatch,
                preset="dune3d")
    doc = json.loads((ROOT / "ACCURACY_dune3d.json").read_text())
    mod.write_md(types.SimpleNamespace(out=tmp_path / "jax.md"), doc, 6000)
    acc_extend.write_md(tmp_path / "port.md", doc, 6000)
    want = _report_lines((tmp_path / "jax.md").read_text())
    assert len(want) > 60 and any(ln.startswith("Tail slope") for ln in want)
    assert _report_lines((tmp_path / "port.md").read_text()) == want


def test_extension_doc_maps_an_accuracy_run_json():
    doc = {"window_train": [{"step": 0, "loss/loss": 1.0}],
           "window_final": {"a": 1}, "window_final_std": {"a": 0},
           "xla_train": [1], "window_short_train": [2],
           "resume": {"resumed_at": 60, "final_step": 120}}
    got = acc_extend.extension_doc(doc)
    assert got["train_window"] == doc["window_train"]
    assert got["final_val"] == {"a": 1} and got["final_val_std"] == {"a": 0}
    assert got["compare_xla"] == [1] and got["compare_window"] == [2]
    assert got["resume"] == [60, 120]
    jax_doc = {"train_window": [], "resume": [60, 120]}
    assert acc_extend.extension_doc(jax_doc) == jax_doc
