"""The program's own spans and counters in a traced run, and the window's
device time by the program span whose host work launched it.

The program (``sparseeventid_tpu_torch/utils/telemetry``) records a span
around each piece of its host work and counts its host syncs while
``telemetry.tracing()`` is on.  ``program_record`` turns what it recorded
into the record's ``program_spans`` and ``program_counters``, in seconds
from the window's start.  ``by_span`` reads the raw Chrome trace of the
window: each device operation's launch is the runtime event of the same
``args.correlation``, and the operation's time inside the window goes to
the innermost span open on the program's main thread at the launch's time,
whatever thread launched it (a backward's kernels are launched by the
autograd engine's own thread while the main thread waits inside
``step.backward``).  The trace's clock is tied to the host's by the
launch of the marker, the trace's first device operation, which the
harness launches right after reading the host clock; without its launch,
by the marker's start on the device.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import DEVICE_CATS, _merged

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside"
MAIN = "main"


def program_record(tracer, t0: float) -> Dict:
    """The tracer's records -> ``program_spans``: [name, thread, parent,
    start s, end s] from ``t0`` (host seconds of ``time.perf_counter``;
    thread "main" for the thread that turned tracing on, else its name;
    end None for a span still open when recording stopped), and
    ``program_counters``: [name, span index, n] (-1: no span open)."""
    spans = [[s.name,
              MAIN if s.thread == tracer.main else tracer.threads[s.thread],
              s.parent, s.start_ns * 1e-9 - t0,
              None if s.end_ns is None else s.end_ns * 1e-9 - t0]
             for s in tracer.spans]
    counts = [[c.name, c.span, c.n] for c in tracer.counts]
    return {"program_spans": spans, "program_counters": counts}


def load_events(path: Path) -> List[Dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


class MainSpans:
    """The main thread's spans: the innermost one open at a host time."""

    def __init__(self, program_spans: Sequence, t0: float):
        self.index = [i for i, s in enumerate(program_spans) if s[1] == MAIN]
        self.spans = program_spans
        self.t0 = t0
        self.starts = [program_spans[i][3] for i in self.index]

    def innermost(self, host_s: float) -> Optional[int]:
        """The index of the innermost main-thread span open at ``host_s``
        (host seconds), else None."""
        t = host_s - self.t0
        k = bisect.bisect_right(self.starts, t) - 1
        i = self.index[k] if k >= 0 else -1
        while i >= 0:
            _, _, parent, start, end = self.spans[i]
            if start <= t and (end is None or t < end):
                return i
            i = parent
        return None

    def path(self, i: Optional[int]) -> str:
        """The names from the outermost span down to span ``i``."""
        if i is None:
            return OUTSIDE
        names = []
        while i >= 0:
            names.append(self.spans[i][0])
            i = self.spans[i][2]
        return "/".join(reversed(names))


def by_span(events: Sequence[Dict], marker_host_s: float,
            window: Tuple[float, float],
            bench_spans: Sequence[Tuple[str, float, float]],
            program_spans: Sequence, t0: float) -> Dict:
    """-> span_device_s and span_launches (the device seconds inside the
    window, and the number, of the operations launched under each
    main-thread span, keyed by its path, "step/step.forward/step.plans";
    "outside" for those launched under none), and idle_gaps (the ten
    longest, each named by the benchmark's span at its middle, "/", and
    the innermost program span there: "next_args/prepare.input").
    ``window`` and ``bench_spans`` are host seconds; ``program_spans``
    seconds from ``t0``."""
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    if not ops:
        raise ValueError("the trace holds no device operation")
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    marker = ops[0]
    anchor = launches.get(marker.get("args", {}).get("correlation"),
                          float(marker["ts"]))
    offset = anchor - marker_host_s * 1e6  # trace us - host us
    w0, w1 = (t * 1e6 + offset for t in window)
    main = MainSpans(program_spans, t0)
    device_s: Dict[str, float] = {}
    count: Dict[str, int] = {}
    intervals = []
    for e in ops[1:]:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        intervals.append([a, b])
        launch = launches.get(e.get("args", {}).get("correlation"))
        key = (OUTSIDE if launch is None else
               main.path(main.innermost((launch - offset) * 1e-6)))
        device_s[key] = device_s.get(key, 0.0) + (b - a) * 1e-6
        count[key] = count.get(key, 0) + 1
    merged = _merged(intervals)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    def named(a, b):
        mid = ((a + b) / 2 - offset) * 1e-6
        outer = next((n for n, s, e in bench_spans if s <= mid < e),
                     "between spans")
        inner = main.innermost(mid)
        return outer if inner is None else f"{outer}/{program_spans[inner][0]}"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "span_device_s": device_s,
        "span_launches": count,
        "idle_gaps": [[named(a, b), (b - a) * 1e-6] for a, b in longest],
    }
