"""The work of a train step, counted from the sites alone, so it is the
same whatever implements the convs.

``event_counts`` counts, per event, each level's sites and the neighbour
pairs of its submanifold kernel (and of the initial kernel at level 0).
From those:

- ``useful_macs``: the matched (in, out) pairs of every encoder conv x Cin
  x Cout, x3 for forward, dX and dW, the strided downsample one pair an
  input site, plus the 1x1 bottleneck: a copy of the program's
  ``scripts/bench.useful_macs_per_train_step``, with the configuration's
  kernels, so it also counts 2-D wire planes;
- ``conv_roofline_s``: per sparse conv and pass (forward, dX, dW; the
  initial conv has no dX) the larger of its operations over the peak rate
  and its bytes over the memory bandwidth, summed.  Bytes: bf16 features
  in and out and bf16 weights read once (dW writes float32), each input
  byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import Level, _find, coarser, filters, kernel_offsets, make_level


def _pair_counts(level: Level, kernel: Sequence[int], n_events: int):
    counts = torch.zeros(n_events, dtype=torch.int64, device=level.keys.device)
    for off in kernel_offsets(kernel, centered=True):
        hit, _ = _find(level, level.batch,
                       level.coords + torch.as_tensor(off, device=counts.device))
        counts += torch.bincount(level.batch[hit], minlength=n_events)
    return counts


def event_counts(coords: List[np.ndarray], arch: Dict, grid: Sequence[int],
                 device) -> Dict[str, np.ndarray]:
    """Per event (rows: events in the given order): ``sites`` i64[E,
    depth + 1], ``pairs`` i64[E, depth + 1] of the series kernel,
    ``initial_pairs`` i64[E]."""
    n = len(coords)
    b = torch.cat([torch.full((len(c),), i, dtype=torch.int64)
                   for i, c in enumerate(coords)]).to(device)
    c = torch.from_numpy(np.concatenate(coords)).to(device)
    level, _ = make_level(b, c, grid)
    depth = int(arch["depth"])
    sites, pairs = [], []
    initial = _pair_counts(level, arch["initial_kernel"], n)
    for l in range(depth + 1):
        sites.append(torch.bincount(level.batch, minlength=n))
        pairs.append(_pair_counts(level, arch["series_kernel"], n))
        if l < depth:
            level = coarser(level, arch["stride"])
    return {"sites": torch.stack(sites, 1).cpu().numpy(),
            "pairs": torch.stack(pairs, 1).cpu().numpy(),
            "initial_pairs": initial.cpu().numpy()}


def useful_macs(counts: Dict[str, np.ndarray], arch: Dict) -> np.ndarray:
    """Useful MACs of a train step, per event (``event_counts`` rows)."""
    ch = filters(arch)
    depth, bpl = int(arch["depth"]), int(arch["blocks_per_layer"])
    s, p = counts["sites"].astype(np.float64), counts["pairs"].astype(np.float64)
    macs = counts["initial_pairs"].astype(np.float64) * 1 * ch[0]
    for l in range(depth):
        macs += p[:, l] * ch[l] * ch[l] * 2 * bpl
        macs += s[:, l] * ch[l] * ch[l + 1]
    macs += p[:, depth] * ch[depth] * ch[depth] * 2 * bpl
    macs += s[:, depth] * ch[depth] * int(arch["n_output_filters"])
    return 3 * macs


def conv_roofline_s(counts: Dict[str, np.ndarray], rows: Sequence[int],
                    arch: Dict, flops_per_s: float,
                    bytes_per_s: float) -> float:
    """The least time of one step's sparse convs on the batch of events
    ``rows``: per conv and pass max(operations / rate, bytes / bandwidth)."""
    rows = np.asarray(rows)
    s = counts["sites"][rows].sum(0).astype(np.float64)
    p = counts["pairs"][rows].sum(0).astype(np.float64)
    p0 = float(counts["initial_pairs"][rows].sum())
    ch = filters(arch)
    depth, bpl = int(arch["depth"]), int(arch["blocks_per_layer"])
    k0 = int(np.prod(arch["initial_kernel"]))
    ks = int(np.prod(arch["series_kernel"]))
    kd = int(np.prod(arch["stride"]))
    total = 0.0

    def conv(pairs, cin, cout, k, n_in, n_out, passes, count=1):
        nonlocal total
        flop = 2.0 * pairs * cin * cout
        feats = 2.0 * (n_in * cin + n_out * cout)
        for kind in passes:
            # forward and dX read the bf16 weights; dW writes float32
            nbytes = feats + (4.0 if kind == "dw" else 2.0) * k * cin * cout
            total += count * max(flop / flops_per_s, nbytes / bytes_per_s)

    conv(p0, 1, ch[0], k0, s[0], s[0], ("fwd", "dw"))
    for l in range(depth + 1):
        conv(p[l], ch[l], ch[l], ks, s[l], s[l], ("fwd", "dx", "dw"),
             count=2 * bpl)
        if l < depth:
            conv(s[l], ch[l], ch[l + 1], kd, s[l], s[l + 1],
                 ("fwd", "dx", "dw"))
    return total
