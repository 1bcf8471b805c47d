"""The program's tracer (``utils/telemetry``): off it records and allocates
nothing; on, spans nest by thread with parents and steps, a train session
records every span where its work happens, sync warnings are counted each
time against the innermost span, and ``run.profile`` turns it on."""

from __future__ import annotations

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.io.dataset import BatchLoader
from sparseeventid_tpu_torch.utils import telemetry

SMALL = ["run.compute_mode=CPU", "framework.sparse_backend=window",
         "encoder.depth=2", "encoder.blocks_per_layer=1",
         "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
         "data.max_voxels=256", "data.synthetic_events=8", "head.hidden=32",
         "run.minibatch_size=2", "data.active=[train]"]


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_off_records_nothing_and_costs_no_allocation(monkeypatch):
    """Off, a span is the one shared no-op and a count returns at once:
    nothing is made, no clock is read, no lock is taken."""

    def refuse(*args, **kwargs):
        raise AssertionError("the tracer did work while off")

    monkeypatch.setattr(telemetry, "perf_counter_ns", refuse)
    monkeypatch.setattr(telemetry, "_OpenSpan", refuse)
    monkeypatch.setattr(telemetry.Tracer, "count", refuse)
    monkeypatch.setattr(telemetry.threading, "Lock", refuse)
    assert telemetry.span("a") is telemetry.span("b", new_step=True)
    for _ in range(3):
        with telemetry.span("a") as a:
            with telemetry.span("b", new_step=True):
                telemetry.count("c")
                telemetry.count("c", 5)
        assert a is telemetry.span("c")
    assert telemetry._tracer is None


def test_spans_nest_by_thread_with_parents_and_steps():
    class Dataset:
        def __len__(self):
            return 8

        def batch(self, indices):
            with telemetry.span("read"):
                return {"index": np.asarray(indices)}

    with telemetry.tracing() as tracer:
        with telemetry.span("next_args", new_step=True):
            loader = BatchLoader(Dataset(), 2, prefetch=1)
            try:
                next(loader)
                # the worker fills the queue, then waits for room
                while not any(r[0] == "loader.put_blocked"
                              for r in list(tracer._records)):
                    time.sleep(0.01)
                with telemetry.span("inner"):
                    telemetry.count("c", 2)
            finally:
                loader.stop()
        with telemetry.span("next_args", new_step=True):
            telemetry.count("c")
    spans = tracer.spans
    assert spans, "nothing recorded"
    main = [s for s in spans if s.thread == tracer.main]
    assert [s.name for s in main] == ["next_args", "loader.get", "inner",
                                      "next_args"]
    assert [s.parent for s in main] == [-1, 0, 0, -1]
    assert [s.step for s in main] == [0, 0, 0, 1]
    worker = [(i, s) for i, s in enumerate(spans) if s.thread != tracer.main]
    assert tracer.threads[worker[0][1].thread] != tracer.threads[tracer.main]
    by_index = dict(worker)
    for i, s in worker:
        if s.name == "read":
            assert by_index[s.parent].name == "loader.assemble"
        else:
            assert s.name in ("loader.assemble", "loader.put_blocked")
            assert s.parent == -1
    assert any(s.name == "loader.put_blocked" for _, s in worker)
    assert all(s.end_ns is None or s.end_ns >= s.start_ns for s in spans)
    inner = spans.index(main[2])
    assert sorted(tracer.counts) == sorted([
        telemetry.Count("c", inner, 2),
        telemetry.Count("c", spans.index(main[3]), 1)])
    assert telemetry._tracer is None
    with telemetry.tracing():
        with pytest.raises(RuntimeError, match="already recording"):
            with telemetry.tracing():
                pass


MAIN_ORDER = ["next_args", "loader.get", "prepare.input",
              "prepare.plans_copy", "step", "step.forward", "step.plans",
              "step.loss", "step.backward", "step.metrics", "step.optimizer"]


@pytest.mark.parametrize("widened", [False, True])
def test_train_session_records_every_span(tmp_path, one_torch_thread,
                                          widened):
    from sparseeventid_tpu_torch.train.evaluate import build_dataset
    from sparseeventid_tpu_torch.train.trainer import open_run

    cfg = load_config("synthetic", SMALL + [f"output_dir={tmp_path}"])
    with open_run(cfg, {"train": build_dataset(cfg, "train")},
                  device="cpu") as session:
        geo = session.planner.geometry
        if widened:  # lists far too short: every batch is built twice
            geo.update(ov_caps=[16] * len(geo["ov_caps"]),
                       ov_cap_initial=16,
                       ov_caps_down=[16] * len(geo["ov_caps_down"]))
        session.planner.cache.clear()
        with telemetry.tracing() as tracer:
            for i in range(2):
                session.step(session.next_args(), i)
    spans = tracer.spans
    main = [s for s in spans if s.thread == tracer.main]
    assert [s.name for s in main] == MAIN_ORDER * 2
    names = [s.name for s in spans]
    for s in main:
        parent = names[s.parent] if s.parent >= 0 else None
        expect = {"next_args": None, "step": None, "step.plans": "step.forward",
                  "loader.get": "next_args", "prepare.input": "next_args",
                  "prepare.plans_copy": "next_args"}.get(s.name, "step")
        assert parent == expect, s
    assert [s.step for s in main] == [0] * 11 + [1] * 11
    loader = [s for s in spans if s.thread != tracer.main]
    assert {"loader.assemble", "plans.build"} <= {s.name for s in loader}
    for s in loader:
        if s.name == "plans.rebuild":
            assert names[s.parent] == "plans.build"
    assert any(s.name == "plans.rebuild" for s in loader) == widened


def test_host_syncs_count_each_warning_against_the_innermost_span():
    def sync():
        warnings.warn(telemetry.SYNC_WARNING + " (Triggered internally)")

    def on_thread():
        sync()

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with telemetry.tracing() as tracer:
            with telemetry.span("step"):
                sync()
                with telemetry.span("step.backward"):
                    for _ in range(3):
                        sync()  # one call site, counted every time
                    t = threading.Thread(target=on_thread)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
                warnings.warn("something else")
            sync()
        warnings.warn(telemetry.SYNC_WARNING)  # off: shown, not counted
    counts = {(tracer.spans[c.span].name if c.span >= 0 else None): c.n
              for c in tracer.counts}
    assert counts == {"step": 1, "step.backward": 4, None: 1}
    assert [str(w.message) for w in shown] == ["something else",
                                               telemetry.SYNC_WARNING]


def test_run_profile_turns_the_tracer_on_and_restores_sync_mode(
        tmp_path, monkeypatch, one_torch_thread):
    from sparseeventid_tpu_torch.train import trainer

    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    seen = []
    tracing = telemetry.tracing

    def recording(profile=False):
        seen.append(profile)
        return tracing(profile)

    monkeypatch.setattr(telemetry, "tracing", recording)
    cfg = load_config("synthetic", SMALL + [
        f"output_dir={tmp_path}", "run.profile=true", "mode.iterations=2"])
    trainer.train(cfg)
    assert seen == [True]
    assert modes == [0, "warn", 0]
    assert telemetry._tracer is None
    trace = json.loads((tmp_path / "synthetic" / str(cfg.run.id) / "profile"
                        / "trace.json").read_text())
    ranges = {e.get("name") for e in trace["traceEvents"]}
    assert {"next_args", "step.forward", "step.backward",
            "step.optimizer"} <= ranges
