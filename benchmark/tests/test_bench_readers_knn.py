"""The readers of the neighbour search's metrics (``knn_device_ms.train``,
``knn_roofline.train``, ``mfu_fp32.train``) on a canned record built by the
harness's own reduction from a canned trace, and nothing read where the
record lacks what they read (a program without the ``knn`` kernel, a card
whose float32 peak is not known).  Their canned values are ``CANNED`` here,
beside ``test_bench_readers.EXPECTED``, until they are folded into it: this
module's ``test_every_metric_has_a_canned_value`` holds the two together
against ``BENCHMARK.json``, and ``benchmark/conftest.py`` skips the one of
``test_bench_readers`` with a reason while the metrics it misses are
exactly ``CANNED``'s."""

from __future__ import annotations

import json

import pytest

import test_bench_readers
from tiny import ROOT

from seidbench import harness, trace

KNN = "void (anonymous namespace)::knn_topk_kernel<20>(float const*, " \
      "unsigned char const*, int, int, int, long*)"
TRACE = {"traceEvents": [
    {"ph": "X", "cat": "kernel", "name": "fill marker", "ts": 1000.0, "dur": 1.0},
    {"ph": "X", "cat": "kernel", "name": KNN, "ts": 1100.0, "dur": 40.0},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1150.0, "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": KNN, "ts": 1300.0, "dur": 20.0},
]}
FAMILIES = {"sparse_conv": ["conv_tc_kernel"], "knn": ["knn_topk_kernel"]}
CANNED = {
    "knn_device_ms.train": 1e3 * 60e-6 / 2,
    "knn_roofline.train": 100.0 * 15e-6 / 60e-6,
    "mfu_fp32.train": 100.0 * 0.1e-3 / 0.35e-3,
}


def test_every_metric_has_a_canned_value():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    assert not set(CANNED) & set(test_bench_readers.EXPECTED)
    assert {m["name"] for m in bench["per_layer"]} == (
        set(test_bench_readers.EXPECTED) | set(CANNED))


def _record(tmp_path, **extra):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    spans = [("next_args", 1.05e-3, 1.2e-3), ("step", 1.2e-3, 1.4e-3)]
    record = {"window_s": 0.35e-3, "steps": 2, "events": 16,
              "spans": [(n, s - 1.05e-3, e - 1.05e-3) for n, s, e in spans],
              "counters": {}, **extra}
    record.update(trace.summarize(trace.load(path), 1.0e-3,
                                  (1.05e-3, 1.40e-3), spans, FAMILIES))
    return record


@pytest.mark.parametrize("name", sorted(CANNED))
def test_reader(tmp_path, name):
    record = _record(tmp_path, knn_roofline_s=15e-6, useful_fp32_s=0.1e-3)
    assert record["family_s"]["knn"] == pytest.approx(60e-6)
    assert record["unnamed"] == ["gemm"]
    value = harness.read_metric(ROOT / "metrics", name, record)
    assert value == pytest.approx(CANNED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(CANNED))
def test_nothing_to_read(tmp_path, name):
    """A trace without the kernel (the parent program's plain search) and a
    record without the family's keys read nothing."""
    plain = {"traceEvents": [e for e in TRACE["traceEvents"]
                             if e["name"] != KNN]}
    path = tmp_path / "plain.json"
    path.write_text(json.dumps(plain))
    record = {"window_s": 0.35e-3, "steps": 2, "knn_roofline_s": 15e-6}
    record.update(trace.summarize(trace.load(path), 1.0e-3,
                                  (1.05e-3, 1.40e-3), [], FAMILIES))
    if name != "mfu_fp32.train":
        assert harness.read_metric(ROOT / "metrics", name, record) is None
    assert harness.read_metric(ROOT / "metrics", name, {
        "window_s": 1.0, "steps": 2}) is None
