"""The program's spans in a traced run (``seidbench/spans.py``): its
records in window seconds, the window's device time and launches by the
main-thread span open at each launch (by ``correlation``), idle gaps named
by the benchmark's span and the program's, and the readers of the
program's spans and counters on a canned record."""

from __future__ import annotations

import pytest
import torch

from tiny import ROOT

from seidbench import harness, spans, trace

CONV = "void (anonymous namespace)::conv_tc_kernel<seid::FwdConv, 4>(int)"


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 2.0, "tid": tid, "args": {"correlation": corr}}


# trace us; the marker's launch at 1000 us is host 1.0 ms, so trace us are
# host us here; the window is host [1.05, 1.40] ms
EVENTS = [
    _launch(1000.0, 1), _op("fill marker", 1003.0, 1.0, 1),
    _launch(1160.0, 2, name="cudaMemcpyAsync"),
    _op("Memcpy HtoD", 1165.0, 10.0, 2, "gpu_memcpy"),
    _launch(1210.0, 4), _op("plan_meta", 1219.0, 5.0, 4),
    _launch(1225.0, 3), _op(CONV, 1230.0, 50.0, 3),
    # the backward's launch comes from the autograd engine's thread
    _launch(1285.0, 5, tid=999), _op("batch_norm_backward", 1290.0, 30.0, 5),
    _launch(1362.0, 8), _launch(1365.0, 6), _op("adam", 1370.0, 20.0, 6),
    _op("orphan", 1392.0, 4.0, 7),  # no launch in the trace
    _op("tail", 1396.0, 10.0, 8),  # cut at the window's end
]
T0 = 1.05e-3
WINDOW = (T0, 1.40e-3)
BENCH = [("next_args", 1.05e-3, 1.2e-3), ("step", 1.2e-3, 1.4e-3)]


def _us(a, b):
    return [(a - 1050.0) * 1e-6, None if b is None else (b - 1050.0) * 1e-6]


PROGRAM = [
    ["next_args", "main", -1, *_us(1052, 1198)],  # 0
    ["loader.get", "main", 0, *_us(1055, 1080)],
    ["prepare.input", "main", 0, *_us(1080, 1150)],  # 2
    ["prepare.plans_copy", "main", 0, *_us(1150, 1190)],
    ["loader.assemble", "batch-loader", -1, *_us(1060, 1110)],
    ["plans.build", "batch-loader", -1, *_us(1110, 1160)],
    ["step", "main", -1, *_us(1202, 1398)],  # 6
    ["step.forward", "main", 6, *_us(1205, 1260)],
    ["step.plans", "main", 7, *_us(1206, 1220)],
    ["step.loss", "main", 6, *_us(1260, 1270)],
    ["step.backward", "main", 6, *_us(1270, 1350)],  # 10
    ["step.metrics", "main", 6, *_us(1350, 1360)],
    ["step.optimizer", "main", 6, *_us(1360, 1395)],
    ["loader.assemble", "batch-loader", -1, *_us(1160, 1250)],
    ["plans.build", "batch-loader", -1, *_us(1250, None)],  # still open
]
COUNTERS = [["host_syncs", 2, 3], ["host_syncs", 10, 2],
            ["host_syncs", -1, 5]]


def _record():
    record = {"window_s": 350e-6, "steps": 1, "events": 8,
              "spans": [(n, s - T0, e - T0) for n, s, e in BENCH],
              "program_spans": PROGRAM, "program_counters": COUNTERS}
    record.update(spans.by_span(EVENTS, 1.0e-3, WINDOW, BENCH, PROGRAM, T0))
    return record


def test_device_time_and_launches_by_span():
    r = _record()
    assert r["span_device_s"] == pytest.approx({
        "next_args/prepare.plans_copy": 10e-6,
        "step/step.forward/step.plans": 5e-6,
        "step/step.forward": 50e-6,
        "step/step.backward": 30e-6,
        "step/step.optimizer": 24e-6,
        "outside": 4e-6}, rel=1e-9)
    assert r["span_launches"] == {
        "next_args/prepare.plans_copy": 1, "step/step.forward/step.plans": 1,
        "step/step.forward": 1, "step/step.backward": 1,
        "step/step.optimizer": 2, "outside": 1}


def test_gaps_named_by_the_benchmark_span_and_the_program_span():
    gaps = _record()["idle_gaps"]
    assert [n for n, _ in gaps] == [
        "next_args/prepare.input", "step/step.backward",
        "next_args/next_args", "step/step.backward", "step/step.forward",
        "step/step.optimizer"]
    assert [g for _, g in gaps] == pytest.approx(
        [115e-6, 50e-6, 44e-6, 10e-6, 6e-6, 2e-6], rel=1e-9)


def test_gap_names_unchanged_without_program_spans():
    ops = trace.device_ops({"traceEvents": EVENTS})
    out = trace.summarize(ops, 1.0e-3, WINDOW, BENCH, {"sparse_conv": []})
    assert {n for n, _ in out["idle_gaps"]} == {"next_args", "step"}
    assert all("/" not in n for n, _ in out["idle_gaps"])


NEW = {
    "loader_wait_ms.train": 0.025,
    "input_prepare_ms.train": 0.070,
    "plans_copy_ms.train": 0.040,
    "plan_build_ms.train": 0.050,
    "loader_busy_share.train": 100.0 * 340e-6 / 350e-6,
    "forward_dispatch_ms.train": 0.055,
    "backward_dispatch_ms.train": 0.080,
    "optimizer_dispatch_ms.train": 0.035,
    "host_syncs_per_step.train": 5.0,
    "step_host_us_per_launch.train": 196.0 / 5,
    "forward_device_ms.train": 0.055,
    "backward_device_ms.train": 0.030,
    "optimizer_device_ms.train": 0.024,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_of_the_program_spans(name):
    value = harness.read_metric(ROOT / "metrics", name, _record())
    assert value == pytest.approx(NEW[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_without_program_spans_returns_nothing(name):
    record = {"window_s": 1.0, "steps": 3, "events": 24,
              "spans": [("next_args", 0.0, 0.1), ("step", 0.1, 0.5)],
              "counters": {"plan_cache_hits": 0, "plan_cache_misses": 0,
                           "plans_widened": 0, "batches_assembled": 3},
              "busy_s": 0.4, "family_s": {"sparse_conv": 0.1, "other": 0.3}}
    assert harness.read_metric(ROOT / "metrics", name, record) is None


def test_program_record_in_window_seconds():
    import threading
    import time

    from sparseeventid_tpu_torch.utils import telemetry

    def work():
        with telemetry.span("loader.assemble"):
            telemetry.count("host_syncs")

    with telemetry.tracing() as tracer:
        t0 = time.perf_counter()
        with telemetry.span("step", new_step=True):
            thread = threading.Thread(target=work, name="batch-loader")
            thread.start()
            thread.join(timeout=30)
        t1 = time.perf_counter()
    assert not thread.is_alive()
    out = spans.program_record(tracer, t0)
    step, assemble = out["program_spans"]
    assert step[:3] == ["step", "main", -1]
    assert assemble[:3] == ["loader.assemble", "batch-loader", -1]
    assert 0.0 <= step[3] <= assemble[3] <= assemble[4] <= step[4] <= t1 - t0
    assert out["program_counters"] == [["host_syncs", 1, 1]]


@pytest.mark.card
def test_one_item_counts_one_sync(card):
    from sparseeventid_tpu_torch.utils import telemetry

    x = torch.arange(8.0, device=card)
    torch.cuda.synchronize(card)
    mode = torch.cuda.get_sync_debug_mode()
    with telemetry.tracing() as tracer:
        with telemetry.span("step"):
            y = x * 2.0
            with telemetry.span("read"):
                y.sum().item()
    assert torch.cuda.get_sync_debug_mode() == mode
    assert [(tracer.spans[c.span].name, c.n) for c in tracer.counts
            if c.name == "host_syncs"] == [("read", 1)]
