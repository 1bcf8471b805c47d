"""Reduction of a ``torch.profiler`` Chrome trace (CUDA activity only) to
what the per-layer readers need: the device operations inside the timed
window, the busy time (the union of their intervals), the time of each
kernel family, and the idle gaps named by the benchmark span the host was
in.

The trace's clock is tied to the host's by a marker: the first device
operation of the trace is a fill the harness launches on an idle device
right after reading the host clock.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(\w+)")


def device_ops(trace: Dict) -> List[Tuple[str, str, float, float]]:
    """(category, name, start us, duration us) of every device operation,
    by start."""
    ops = [(e.get("cat", ""), e.get("name", ""), float(e["ts"]),
            float(e.get("dur", 0.0)))
           for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(ops, key=lambda o: o[2])


def load(path: Path) -> List[Tuple[str, str, float, float]]:
    with open(path) as f:
        return device_ops(json.load(f))


def family_of(name: str, families: Dict[str, Sequence[str]]) -> Optional[str]:
    """The family whose list names the kernel's CUDA function (the
    program's kernels live in anonymous namespaces), else None."""
    found = PORT_KERNEL.search(name)
    fn = found.group(1) if found else name
    for family, names in families.items():
        if fn in names:
            return family
    return None


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(ops, marker_host_s: float, window: Tuple[float, float],
              spans: Sequence[Tuple[str, float, float]],
              families: Dict[str, Sequence[str]]) -> Dict:
    """-> busy_s, family_s (seconds by family; kernels of no family under
    "other"), unnamed (the kernels of no family), device_ops (the ten
    operations by total time), idle_gaps (the ten longest, each named by
    the span open at its middle).  ``window`` and ``spans`` are host
    seconds; the first operation of ``ops`` is the marker."""
    if not ops:
        raise ValueError("the trace holds no device operation")
    offset = ops[0][2] - marker_host_s * 1e6  # trace us - host us
    w0, w1 = (t * 1e6 + offset for t in window)
    inside = []
    for cat, name, ts, dur in ops[1:]:
        a, b = max(ts, w0), min(ts + dur, w1)
        if b > a:
            inside.append((cat, name, a, b))
    merged = _merged([[a, b] for _, _, a, b in inside])
    busy = sum(b - a for a, b in merged)
    family_s: Dict[str, float] = {f: 0.0 for f in families}
    family_s["other"] = 0.0
    by_name: Dict[str, float] = {}
    unnamed = set()
    for cat, name, a, b in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        if cat != "kernel":
            continue
        fam = family_of(name, families)
        if fam is None:
            unnamed.add(name)
            fam = "other"
        family_s[fam] += (b - a) / 1e6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [(n, s * 1e6 + offset, e * 1e6 + offset) for n, s, e in spans]

    def named(a, b):
        mid = 0.5 * (a + b)
        for n, s, e in host:
            if s <= mid < e:
                return n
        return "between spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy / 1e6,
        "family_s": family_s,
        "unnamed": sorted(unnamed),
        "device_ops": [[n[:160], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[named(a, b), (b - a) / 1e6] for a, b in longest],
    }
