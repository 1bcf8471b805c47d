"""The plain reference against the program's CPU step at a tiny size, and
the control and planted faults against the reference."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from tiny import tiny_spec

from seidbench import check, generator, harness, reference


def _run(tmp_path: Path, precision: str = "float32", seed: int = 2**31 + 5):
    spec = tiny_spec(tmp_path, precision)
    return harness.run_cell(spec, seed, 0.5, False, torch.device("cpu"), 0.0,
                            log=lambda s: None)


def test_reference_follows_the_program(tmp_path, few_threads):
    result = _run(tmp_path)
    values = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"], values
    assert values["input_mismatch"] == 0
    assert values["loss_gap"] < 1e-5
    assert values["grad_gap"] < 1e-4
    assert values["update_gap"] < 1e-3
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_reference_follows_the_bf16_program(tmp_path, few_threads):
    result = _run(tmp_path, "bfloat16", seed=99)
    assert result["correct"], result["checks"]


def _readings(spec, seed, **kw):
    cfg = spec["config"]
    events, labels = generator.make_pool(6, seed, cfg["generator"])
    batches = [([events[i] for i in rows],
                {k: v[rows] for k, v in labels.items()})
               for rows in ([0, 1], [2, 3], [4, 5])]
    weights = reference.make_weights(cfg["arch"], seed, "cpu")
    return reference.train_steps(cfg, weights, batches, seed, 16, "cpu", **kw)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails(tmp_path, few_threads, seed):
    """The reference computed in fp8 in the program's place, against the
    limits of the tiny bf16 cell, comes out not correct."""
    spec = tiny_spec(tmp_path)
    ref = _readings(spec, seed)
    control = _readings(spec, seed, precision="float8_e4m3fn")
    values = check.numbers(control, ref, [], [], 0, 0)
    ok, _ = check.verdict(values, tiny_spec(tmp_path, "bfloat16")["limits"])
    assert not ok, values


@pytest.mark.parametrize("variant", ["half", "alter"])
def test_planted_faults_read_far(tmp_path, few_threads, variant):
    spec = tiny_spec(tmp_path)
    ref = _readings(spec, 21)
    values = check.numbers(_readings(spec, 21, variant=variant), ref, [], [],
                           0, 0)
    ok, _ = check.verdict(values, spec["limits"])
    assert not ok, values
