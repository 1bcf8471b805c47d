"""A tiny cell for the CPU tests: the dune3d recipe cut to a 64^3 grid,
depth 2, one block a level, 8 -> 24 filters, float32."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

OVERRIDES = ["run.precision=float32", "framework.remat=false",
             "encoder.depth=2", "encoder.blocks_per_layer=1",
             "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
             "head.hidden=16"]


# set from this cell's readings on the CPU: float32 programs read gaps
# under 1e-5; bfloat16 ones input 0.003, loss 2e-5, gradient 0.009, conv
# gradient 0.017, change 0.13, and the fp8 control input 0.03, loss 2e-4,
# gradient 0.14, conv gradient 0.03-0.08
LIMITS = {
    "float32": {"input_mismatch": 0, "input_gap": 1e-3, "loss_gap": 1e-3,
                "grad_gap": 1e-2, "conv_grad_gap": 1e-3, "update_gap": 0.3,
                "dropped": 0, "failed_steps": 0},
    "bfloat16": {"input_mismatch": 0, "input_gap": 0.01, "loss_gap": 8e-5,
                 "grad_gap": 0.05, "conv_grad_gap": 0.04, "update_gap": 0.3,
                 "dropped": 0, "failed_steps": 0},
}

# a split the plan cache holds, filled before the first step, as the
# cached cell's traffic
CACHED = {"batch": 2, "pool": 8, "split": 8, "access": "random_events",
          "run_length": 1, "warmup_steps": 4, "fill_cache": True}


def tiny_spec(tmp_path: Path, precision: str = "float32",
              traffic: dict = None) -> dict:
    from seidbench import harness

    with open(ROOT / "configs" / "dune3d.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["overrides"] = [o.replace("float32", precision) for o in OVERRIDES]
    cfg["precision"] = precision
    cfg["grid"] = cfg["larcv_grid"] = [64, 64, 64]
    cfg["max_voxels"] = 1024
    cfg["arch"].update(depth=2, blocks_per_layer=1, n_initial_filters=8,
                       n_output_filters=16, head_hidden=16)
    cfg["generator"] = {"image_size": [64, 64, 64], "mean_tracks": 3.0,
                        "steps_per_track": 100, "max_voxels": 1024,
                        "planes": False}
    with open(ROOT.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    return {
        "name": "tiny",
        "chips": 1,
        "config": cfg,
        "model": harness.load_model(ROOT / "models" / f"{cfg['model']}.py"),
        "traffic": traffic or {"batch": 2, "pool": 8, "split": 32,
                               "access": "serial_access", "run_length": 1,
                               "warmup_steps": 4},
        "limits": LIMITS[precision],
        "end_to_end": bench["end_to_end"],
        "per_layer": bench["per_layer"],
        "families": {"sparse_conv": []},
        "peaks": {},
        "metrics_dir": ROOT / "metrics",
        "work_dir": tmp_path,
    }
