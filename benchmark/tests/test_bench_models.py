"""The model family seam (``benchmark/models/``, ``harness.load_model``).

The sparse ResNet read through its family gives, on the tiny cell, what
the reference and the harness gave before the seam
(``sparse_resnet_readings.json``): every value equal bit for bit, since
the seam computes each one in the order it did.  A planted family proves
that a run reaches the model through the configuration's family, and
``load_spec`` refuses a configuration that names no known family."""

from __future__ import annotations

import hashlib
import json
import shutil

import numpy as np
import pytest
import torch

from tiny import ROOT, tiny_spec

from seidbench import check, flops, generator, harness, reference

BEFORE = json.loads((ROOT / "tests" / "sparse_resnet_readings.json")
                    .read_text())
SEEDS = [1, 2, 3]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _readings(spec, seed, **kw):
    cfg, model = spec["config"], spec["model"]
    events, labels = generator.make_pool(8, seed, cfg["generator"])
    batches = [([events[i] for i in rows],
                {k: v[rows] for k, v in labels.items()})
               for rows in ([0, 1], [2, 3], [4, 5])]
    weights = model.make_weights(cfg, seed, "cpu")
    return reference.train_steps(model, cfg, weights, batches, seed, 16,
                                 "cpu", **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_readings_are_as_before_the_seam(tmp_path, few_threads,
                                                   seed):
    ref = _readings(tiny_spec(tmp_path), seed)
    want = BEFORE["readings"][str(seed)]
    assert ref.losses == want["losses"]
    assert ref.grad_norms == want["grad_norms"]
    assert ref.change_norms == want["change_norms"]
    assert [[_digest(t) for t in x] for x in ref.inputs] == want["inputs"]


@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_fault_readings_are_as_before_the_seam(
        tmp_path, few_threads, seed):
    spec = tiny_spec(tmp_path)
    ref = _readings(spec, seed)
    for name, kw in (("control", {"precision": "float8_e4m3fn"}),
                     ("half", {"variant": "half"}),
                     ("alter", {"variant": "alter"})):
        values = check.numbers(_readings(spec, seed, **kw), ref, [], [], 0, 0,
                               spec["model"])
        assert values == BEFORE["faults"][str(seed)][name], name


@pytest.mark.parametrize("seed", SEEDS)
def test_checks_against_the_program_are_as_before_the_seam(
        tmp_path, few_threads, seed):
    result = harness.run_cell(tiny_spec(tmp_path), seed, 0.2, False,
                              torch.device("cpu"), 0.0, log=lambda s: None)
    assert result["correct"], result["checks"]
    values = {k: v["value"] for k, v in result["checks"].items()}
    assert values == BEFORE["checks"][str(seed)]


def test_window_work_equals_the_flop_count(tmp_path, few_threads):
    """``sparse_resnet.window_work`` is the sum over the window's batches
    of ``flops.useful_macs`` and ``flops.conv_roofline_s``."""
    spec = tiny_spec(tmp_path)
    cfg, want = spec["config"], BEFORE["window_work"]
    events, _ = generator.make_pool(8, want["pool_seed"], cfg["generator"])
    batches = [np.array(b) for b in want["batches"]]
    peak = {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}
    work = spec["model"].window_work(cfg, events, batches, peak, "cpu")
    assert work == {"useful_flop": want["useful_flop"],
                    "conv_roofline_s": want["conv_roofline_s"]}
    sites = [reference.event_sites(e, cfg)[0] for e in events]
    counts = flops.event_counts(sites, cfg["arch"], cfg["grid"], "cpu")
    macs = flops.useful_macs(counts, cfg["arch"])
    assert work["useful_flop"] == float(sum(
        2.0 * macs[b].sum() for b in batches))
    assert work["conv_roofline_s"] == float(sum(
        flops.conv_roofline_s(counts, b, cfg["arch"], peak["bf16_flops"],
                              peak["hbm_bytes_per_s"]) for b in batches))
    record = harness.layer_record(
        dict(spec, peaks={"cpu": peak}), torch.device("cpu"), 0.0, 1.0,
        len(batches), 2, [], {}, {}, None, None, events, batches)
    assert {k: record[k] for k in work} == work and record["peak"] == peak


PLANTED = '''"""The sparse ResNet whose reference forward returns its logits
doubled: the loop, not a family, takes the loss, so the loss the
reference reads moves far from the program's."""

from seidbench import harness

_base = harness.load_model(harness.bench_root() / "models" /
                           "sparse_resnet.py")
param_shapes = _base.param_shapes
make_weights = _base.make_weights
reference_batch = _base.reference_batch
program_input = _base.program_input
gradient_leaves = _base.gradient_leaves
window_work = _base.window_work
check_program = _base.check_program


def forward(weights, model_input, n_events, cfg, generator, rnd):
    logits = _base.forward(weights, model_input, n_events, cfg, generator,
                           rnd)
    return {k: 2.0 * v for k, v in logits.items()}
'''


def test_planted_family_is_dispatched(tmp_path, few_threads):
    path = tmp_path / "models" / "doubled.py"
    path.parent.mkdir()
    path.write_text(PLANTED)
    spec = dict(tiny_spec(tmp_path), model=harness.load_model(path))
    result = harness.run_cell(spec, 1, 0.2, False, torch.device("cpu"), 0.0,
                              log=lambda s: None)
    assert not result["correct"]
    assert not result["checks"]["loss_gap"]["ok"], result["checks"]
    assert result["checks"]["input_gap"]["ok"]


def _copy(tmp_path, model):
    """A copy of the benchmark whose dune3d configuration names ``model``
    (None: no ``"model"`` key) -> (its root, the configuration's path)."""
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = root / "configs" / "dune3d.json"
    cfg = json.loads(path.read_text())
    if model is None:
        del cfg["model"]
    else:
        cfg["model"] = model
    path.write_text(json.dumps(cfg))
    return root, path


@pytest.mark.parametrize("model", [None, "no_such_family"])
def test_load_spec_refuses_a_config_without_a_known_family(tmp_path, model):
    root, cfg_path = _copy(tmp_path, model)
    with pytest.raises((KeyError, FileNotFoundError)) as err:
        harness.load_spec("dune3d.train.stream", root)
    want = cfg_path if model is None else root / "models" / f"{model}.py"
    assert str(want) in str(err.value)
    assert harness.load_spec("dune2d.train.stream", root)["model"]


def test_a_family_without_every_hook_is_refused(tmp_path):
    path = tmp_path / "partial.py"
    path.write_text("def forward(*args):\n    return {}\n")
    with pytest.raises(AttributeError) as err:
        harness.load_model(path)
    assert str(path) in str(err.value) and "check_program" in str(err.value)
