"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

from __future__ import annotations

import json
import re

import pytest

from tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # the check's time at 24 cells
    full = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert full <= 43200 and cells >= 1
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    from seidbench import check, harness

    spec = harness.load_spec(cell)
    assert spec["chips"] == 1
    assert set(spec["limits"]) == set(check.ORDER)
    for key in ("input_mismatch", "dropped", "failed_steps"):
        assert spec["limits"][key] == 0
    for m in spec["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
    assert "sparse_conv" in spec["families"]
    assert {"batch", "pool", "split", "access", "run_length",
            "warmup_steps"} <= set(spec["traffic"])
    assert spec["traffic"]["warmup_steps"] >= harness.CHECKED_STEPS


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_program(config):
    """The configuration file states what the program loads from its
    recipe, and the reference's parameters are the program's."""
    from seidbench import reference
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.models import build_sparse_classifier

    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    cfg = json.loads((ROOT.parent / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    prog = load_config(cfg["recipe"], cfg["overrides"])
    enc, arch = prog.encoder, cfg["arch"]
    for key in ("depth", "n_initial_filters", "n_output_filters",
                "blocks_per_layer", "filter_size", "leakiness"):
        assert getattr(enc, key) == arch[key], key
    assert prog.data.max_voxels == cfg["max_voxels"]
    assert prog.head.hidden == arch["head_hidden"]
    assert prog.head.dropout == arch["head_dropout"]
    assert prog.mode.optimizer.weight_decay == cfg["optimizer"]["weight_decay"]
    sched = prog.mode.optimizer.lr_schedule
    assert sched.peak_learning_rate == cfg["optimizer"]["peak_lr"]
    model = build_sparse_classifier(prog)
    ik, sks, stride = model.encoder.plan_kernels()
    assert list(ik) == arch["initial_kernel"]
    assert list(sks[0]) == arch["series_kernel"]
    assert list(stride) == arch["stride"]
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert shapes == dict(reference.param_shapes(arch))
