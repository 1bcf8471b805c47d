"""One run of one cell: set-up, the timed window, the check, the result.

Set-up makes the pool of raw events from the seed (``generator.py``), the
weights on the device from the seed (the model family's ``make_weights``),
opens the program's ``RunSession`` on the split (where the traffic says
``fill_cache``, its planner first plans the whole split into its plan
cache, so that the checked steps take their plans from cache hits, as
the window's do) and drives its first steps: the ``checked_steps`` that
the reference follows, then the rest of the traffic's warm-up.  Each
phase's seconds are printed on standard error and kept in the result's
``window``.  The window queues ``next_args()`` and ``step()``
without a fence of its own until the host clock passes ``seconds``, then
waits once (``torch.cuda.synchronize``).  After it the program's state is
freed and the reference recomputes the checked steps.

The model is a configuration's own part: its ``"model"`` key names a
module ``models/<family>.py``, loaded by path, that gives the hooks of
``MODEL_HOOKS`` (``models/sparse_resnet.py`` is one; ``README.md`` says
what each returns).  The run reaches the model only through them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, generator, program, reference, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparseeventid_tpu")
CHECKED_STEPS = 3
MODEL_HOOKS = ("param_shapes", "make_weights", "reference_batch", "forward",
               "program_input", "gradient_leaves", "window_work",
               "check_program")


def forbidden_loaded(modules) -> List[str]:
    """The JAX-side packages among ``modules``, compared by whole top-level
    name: ``sparseeventid_tpu_torch`` is not ``sparseeventid_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def bench_root() -> Path:
    return Path(__file__).resolve().parents[1]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _load(name: str, path: Path):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def load_model(path: Path):
    """The model family module at ``path``; it has to give every hook of
    ``MODEL_HOOKS``."""
    if not path.is_file():
        raise FileNotFoundError(f"no model family module {path}")
    module = _load("model_" + path.stem.replace(".", "_"), path)
    missing = [h for h in MODEL_HOOKS if not callable(getattr(module, h,
                                                               None))]
    if missing:
        raise AttributeError(f"{path} gives no {', '.join(missing)}")
    return module


def load_spec(workload: str, root: Optional[Path] = None) -> Dict:
    """The cell's entry of ``BENCHMARK.json`` and the files it names:
    ``configs/<config>.json``, the model family it names
    (``models/<family>.py``), ``traffic/<traffic>.json``,
    ``workloads/<name>.json`` (the limits of its checks), the metrics it
    reports and the kernel families."""
    root = root or bench_root()
    bench = _json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def reports(metric: Dict) -> bool:
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m)
             and ("workloads" in m or m["moves"] in e2e_names)]
    cfg_path = root / "configs" / f"{cell['config']}.json"
    cfg = _json(cfg_path)
    if "model" not in cfg:
        raise KeyError(f"{cfg_path} names no model family: its \"model\" "
                       f"key names a module of {root / 'models'}")
    return {
        "name": workload,
        "chips": int(cell["chips"]),
        "config": cfg,
        "model": load_model(root / "models" / f"{cfg['model']}.py"),
        "traffic": _json(root / "traffic" / f"{cell['traffic']}.json"),
        "limits": _json(root / "workloads" / f"{workload}.json")["limits"],
        "end_to_end": e2e,
        "per_layer": layer,
        "families": {p.stem: _json(p)["kernels"]
                     for p in sorted((root / "kernels").glob("*.json"))},
        "peaks": _json(root / "peaks.json"),
        "metrics_dir": root / "metrics",
        "work_dir": root.parent / "build" / "benchmark",
    }


def read_metric(metrics_dir: Path, name: str, record: Dict):
    """The metric's reader, ``metrics/<name>.py``'s ``read(record)``."""
    return _load("metric_" + name.replace(".", "_"),
                 metrics_dir / f"{name}.py").read(record)


class Phases:
    """Seconds of each phase of set-up: ``phase(name)`` closes the phase
    that began where the last one ended (the first: at ``t0``)."""

    def __init__(self, t0: float):
        self.times: Dict[str, float] = {}
        self._last = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.times[name] = now - self._last
        self._last = now


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(spec: Dict, seed: int, seconds: float, traced: bool,
             device: torch.device, t_process: float,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> Dict:
    """One run of the cell -> the result line's object."""
    phase = Phases(t_process)
    phase("start")
    cfg, traffic, model = spec["config"], spec["traffic"], spec["model"]
    batch = int(traffic["batch"])
    pool_events, pool_labels = generator.make_pool(
        int(traffic["pool"]), seed, cfg["generator"])
    split = program.Split(pool_events, pool_labels, int(traffic["split"]), cfg)
    phase("pool")
    work = spec["work_dir"]
    weights = model.make_weights(cfg, seed, device)
    _sync(device)
    phase("weights")
    pcfg = program.program_config(cfg, traffic, spec["name"], seed,
                                  work / "runs", device)
    b1 = float(cfg["optimizer"]["b1"])
    window_losses, window_dropped = [], []
    spans: List = []
    prof = marker = None
    with program.open_session(pcfg, split, weights, device,
                              bool(traffic.get("fill_cache"))) as run:
        phase("session")
        prog, prog_labels, dropped = program.checked_steps(
            run, CHECKED_STEPS, weights, b1, model)
        _sync(device)
        checked_counts = program.counters(run, split)
        phase("checked_steps")
        warmup = int(traffic["warmup_steps"])
        for k in range(CHECKED_STEPS, warmup):
            window_dropped.append(
                run.step(run.next_args(), k)["overflow/dropped"])
        step = max(CHECKED_STEPS, warmup)
        _sync(device)
        phase("warmup")
        first_window_step = step
        before = program.counters(run, split)
        if traced:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            _sync(device)
            marker = time.perf_counter()
            torch.ones(1, device=device).fill_(2.0)
            _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        while True:
            a = time.perf_counter()
            if a - t0 >= seconds:
                break
            args = run.next_args()
            b = time.perf_counter()
            metrics = run.step(args, step)
            c = time.perf_counter()
            window_losses.append(metrics["loss/loss"])
            window_dropped.append(metrics["overflow/dropped"])
            spans += [("next_args", a - t0, b - t0), ("step", b - t0, c - t0)]
            step += 1
        a = time.perf_counter()
        _sync(device)
        t1 = time.perf_counter()
        spans.append(("fence", a - t0, t1 - t0))
        window_s = t1 - t0
        steps = step - first_window_step
        peak_bytes = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
        after = program.counters(run, split)
        trace_path = None
        if prof is not None:
            prof.stop()
            work.mkdir(parents=True, exist_ok=True)
            trace_path = work / f"{spec['name']}.trace.json"
            prof.export_chrome_trace(str(trace_path))
            prof = None
        checked_hits, checked_misses = (
            checked_counts[k] - split.at_open[k]
            for k in ("plan_cache_hits", "plan_cache_misses"))
        losses = torch.tensor([float(x) for x in window_losses])
        drops = torch.tensor([int(x) for x in window_dropped],
                             dtype=torch.int64)
        failed_steps = int((~torch.isfinite(losses)).sum())
        dropped_steps = int((drops[len(drops) - len(losses):] > 0).sum())
        dropped += int(drops.sum())
        del run
    window_batches = [split.events_of(k) for k in
                      range(first_window_step, first_window_step + steps)]
    checked = [split.events_of(k) for k in range(CHECKED_STEPS)]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = reference.train_steps(
        model, cfg, weights,
        [([pool_events[i] for i in rows],
          {k: v[rows] for k, v in pool_labels.items()}) for rows in checked],
        int(seed) % 2**31, int(traffic["split"]) // batch, device)
    ref_labels = [{k: v[rows] for k, v in pool_labels.items()}
                  for rows in checked]
    values = check.numbers(prog, ref, prog_labels, ref_labels, dropped,
                           failed_steps, model)
    correct, checks = check.verdict(values, spec["limits"])
    check_s = time.perf_counter() - t_check

    if traced:
        names = [m["name"] for m in spec["per_layer"]]
        record = layer_record(spec, device, t0, window_s, steps, batch,
                              spans, before, after, trace_path, marker,
                              pool_events, window_batches)
        metrics = {}
        for m in spec["per_layer"]:
            value = read_metric(spec["metrics_dir"], m["name"], record)
            if value is None:
                log(f"# {m['name']}: nothing to read in this run")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for name in record.get("unnamed", []):
            log(f"# kernel of no family, summed under other: {name}")
    else:
        names = [m["name"] for m in spec["end_to_end"]]
        record = None
        e2e = {
            "train_events_per_s": steps * batch / window_s,
            "peak_device_gib": peak_bytes / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in e2e}
    missing = [n for n in names if n not in metrics]
    if missing:
        log(f"# metrics not read: {missing}")

    loaded = forbidden_loaded(sys.modules)
    if loaded:
        raise RuntimeError(f"modules loaded in the benchmark's process: "
                           f"{loaded}")
    result = {
        "correct": bool(correct),
        "attempted": steps,
        "failed": failed_steps + dropped_steps,
        "metrics": metrics,
        "device": device_record(device, peak_bytes, record),
    }
    if record is not None:
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
    result["window"] = {"seconds": window_s, "steps": steps,
                        "events": steps * batch, "setup_s": setup_s,
                        "check_s": check_s, "setup_phases": phase.times,
                        "checked_plan_hits": checked_hits,
                        "checked_plan_misses": checked_misses,
                        "segment_rates": segment_rates(spans, batch)}
    result["checks"] = checks
    log("# set-up phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phase.times.items()))
    log(f"# plan cache from the session's start to the end of the checked "
        f"steps: {checked_hits} hits, {checked_misses} misses")
    for line in check.lines(checks):
        log(line)
    return result


def segment_rates(spans, batch: int, length: float = 10.0) -> List[float]:
    """Events a second by the host's clock in each whole ``length``-second
    part of the window, counting the steps whose ``step()`` returned in
    it: how far the rate wanders inside one run."""
    ends = [e for n, s, e in spans if n == "step"]
    parts = int(max(ends, default=0.0) // length)
    counts = [0] * parts
    for e in ends:
        if int(e // length) < parts:
            counts[int(e // length)] += 1
    return [c * batch / length for c in counts]


def device_record(device: torch.device, peak_bytes: int,
                  record: Optional[Dict]) -> Dict:
    out = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(peak_bytes),
    }
    if record is not None and "busy_s" in record:
        out["busy_s"] = record["busy_s"]
        out["window_s"] = record["window_s"]
    return out


def layer_record(spec, device, t0, window_s, steps, batch, spans, before,
                 after, trace_path, marker, pool_events, window_batches
                 ) -> Dict:
    """What the per-layer readers read: spans, counter differences, the
    reduced trace, and the work of the window's batches (the model
    family's ``window_work``)."""
    record = {
        "window_s": window_s,
        "steps": steps,
        "events": steps * batch,
        "spans": spans,
        "counters": {k: after[k] - before[k] for k in after},
        "device_ops": [],
        "idle_gaps": [],
    }
    if trace_path is not None:
        ops = trace.load(trace_path)
        record.update(trace.summarize(
            ops, marker, (t0, t0 + window_s),
            [(n, t0 + s, t0 + e) for n, s, e in spans], spec["families"]))
    peak = spec["peaks"].get(torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")
    if peak is not None and window_batches:
        record.update(spec["model"].window_work(
            spec["config"], pool_events, window_batches, peak, device))
        record["peak"] = peak
    return record
