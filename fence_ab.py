#!/usr/bin/env python3
"""Time the benchmark driver's fixed-batch dune3d train step
(``sparseeventid_tpu_torch/scripts/bench.py``, both regimes at their
defaults) with the driver's fence, one ``torch.cuda.synchronize()`` at the
end of a block of 10 steps, against a fence after every step, in turns in
one process on one NVIDIA card; then profile one block of each for the
share of its wall time the card was busy.

    python3 fence_ab.py [--pairs N]

Each regime: the driver's batch and step (``bench.regime_steps``), its 24
warm-up steps, then N (10) pairs of blocks, the order alternating between
pairs.  Prints the card's name and power limit, then one JSON line a
regime: each side's events/s a pair, their medians, the pairs the
once-a-block side won, the dropped pairs of every step (must be 0), and
each side's wall and device-busy ms in one profiled block
(``chip_smoke._device_profile``; the profiler's own host cost is in the
wall time).  Exits 1 if a step dropped a pair, 2 without a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fence_ab: no CUDA device", file=sys.stderr)
        return 2
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else 10
    sys.path.insert(0, str(HERE))
    from chip_smoke import _device_profile
    from sparseeventid_tpu_torch.scripts import bench

    dev = torch.device("cuda")
    fields = bench.card_fields(dev)
    s = bench.Settings()
    regimes = {"25k": (bench.ACTIVE_VOXELS, 40, bench.WINDOWS_25K, 0.5),
               "36k": (bench.ACTIVE_VOXELS_FULL, None, (), 1.0)}
    dropped = 0
    for name, (voxels, tracks, overrides, qbound) in regimes.items():
        steps, info = bench.regime_steps(voxels, tracks, overrides, qbound,
                                         1.6, s, dev)
        for _ in range(s.warmup):
            steps()
        steps.fence()

        def each_step(steps=steps):
            steps()
            steps.fence()

        sides = {
            "block": lambda steps=steps: bench.timed_rate(
                steps, s.iters, s.batch, steps.fence),
            "step": lambda steps=steps: bench.timed_rate(
                each_step, s.iters, s.batch, steps.fence),
        }
        rates = {k: [] for k in sides}
        for p in range(pairs):
            for k in (("block", "step") if p % 2 == 0 else ("step", "block")):
                rates[k].append(sides[k]())
        profiled = {}
        for k, side in sides.items():
            wall_ms, busy_ms, _, _ = _device_profile(side)
            profiled[k] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                           "busy_share": busy_ms / wall_ms}
        dropped += steps.dropped
        print(json.dumps({
            "regime": name, "occupancy": info["occupancy"], "pairs": pairs,
            "iters": s.iters, "batch": s.batch,
            "block_fence_ev_s": rates["block"],
            "step_fence_ev_s": rates["step"],
            "median_block_fence": float(np.median(rates["block"])),
            "median_step_fence": float(np.median(rates["step"])),
            "block_fence_wins": int(sum(
                a > b for a, b in zip(rates["block"], rates["step"]))),
            "overflow_dropped": steps.dropped, "profiled": profiled,
            **fields}), flush=True)
    return 1 if dropped else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
