"""Each per-layer reader on a canned record, built from a canned profiler
trace by the harness's own reduction."""

from __future__ import annotations

import json

import pytest

from tiny import ROOT

from seidbench import harness, trace

CONV = "void (anonymous namespace)::conv_tc_kernel<seid::FwdConv, 4>(int)"
TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "fill marker", "ts": 1000.0, "dur": 1.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1001.0, "dur": 4.0},
    {"ph": "X", "cat": "kernel", "name": CONV, "ts": 1100.0, "dur": 50.0},
    {"ph": "X", "cat": "kernel", "name": "batch_norm_reduce", "ts": 1140.0, "dur": 30.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1300.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": CONV, "ts": 1390.0, "dur": 40.0},
]}


def _record(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    # the marker ran at host 1.0 ms; the window is host [1.05, 1.40] ms
    spans = [("next_args", 1.05e-3, 1.2e-3), ("step", 1.2e-3, 1.4e-3)]
    record = {"window_s": 0.35e-3, "steps": 2, "events": 16,
              "spans": [(n, s - 1.05e-3, e - 1.05e-3) for n, s, e in spans],
              "counters": {"plan_cache_hits": 6, "plan_cache_misses": 10,
                           "plans_widened": 1, "batches_assembled": 4},
              "useful_flop": 3.5e9, "conv_roofline_s": 2e-6,
              "peak": {"bf16_flops": 1e15, "hbm_bytes_per_s": 3e12}}
    record.update(trace.summarize(trace.load(path), 1.0e-3,
                                  (1.05e-3, 1.40e-3), spans,
                                  {"sparse_conv": ["conv_tc_kernel"]}))
    return record


EXPECTED = {
    "input_wait_ms.train": 0.15e-3 / 1 * 1e3,
    "step_call_ms.train": 0.2e-3 * 1e3,
    "plan_cache_hit_share.train": 37.5,
    "plan_rebuild_share.train": 25.0,
    "mfu.train": 100.0 * 3.5e9 / 0.35e-3 / 1e15,
    "conv_device_ms.train": 1e3 * 60e-6 / 2,
    "other_device_ms.train": 1e3 * 30e-6 / 2,
    "conv_roofline.train": 100.0 * 2e-6 / 60e-6,
    "device_idle_share.train": 100.0 * (1 - 90e-6 / 0.35e-3),
}


def test_every_metric_has_a_canned_value():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    assert {m["name"] for m in bench["per_layer"]} == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(tmp_path, name):
    value = harness.read_metric(ROOT / "metrics", name, _record(tmp_path))
    assert value == pytest.approx(EXPECTED[name], rel=1e-9)


def test_reduction_names_gaps_and_families(tmp_path):
    r = _record(tmp_path)
    # 1100-1170, 1300-1310 and 1390-1400 (the window ends at 1400)
    assert r["busy_s"] == pytest.approx(90e-6)
    assert r["family_s"]["sparse_conv"] == pytest.approx(60e-6)
    assert r["unnamed"] == ["batch_norm_reduce"]
    assert [n for n, _ in r["idle_gaps"]] == ["step", "step", "next_args"]
    assert r["idle_gaps"][0][1] == pytest.approx(130e-6)


@pytest.mark.parametrize("name", ["plan_cache_hit_share.train",
                                  "plan_rebuild_share.train",
                                  "conv_roofline.train", "mfu.train",
                                  "device_idle_share.train"])
def test_reader_with_nothing_to_read_returns_nothing(name):
    record = {"window_s": 1.0, "steps": 0, "events": 0, "spans": [],
              "counters": {"plan_cache_hits": 0, "plan_cache_misses": 0,
                           "plans_widened": 0, "batches_assembled": 0}}
    assert harness.read_metric(ROOT / "metrics", name, record) is None
