"""Run one cell of the benchmark of ``sparseeventid_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

It makes the cell's events and weights from the seed, opens the program's
training run on them, warms up, measures for ``--seconds``, checks the
first steps against the plain reference and prints the result as the last
line of standard output (``--trace 1``: the per-layer metrics from a
``torch.profiler`` trace of the window; ``--trace 0``: the end-to-end
metrics).  Without a CUDA device, or with fewer than the cell asks for, it
exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHES = CHECKOUT / "build" / "benchmark" / "cache"
# every build and kernel cache inside the checkout, at fixed paths; no
# library the port uses may load JAX on its own
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHES / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for path in (str(HERE), str(CHECKOUT)):
    if path not in sys.path:
        sys.path.insert(0, path)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else out.stderr
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        from seidbench import harness

        spec = harness.load_spec(args.workload)
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < spec["chips"]:
            print(f"the cell needs {spec['chips']} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        print(f"# card: {card_line()}", file=sys.stderr, flush=True)
        result = harness.run_cell(spec, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T_PROCESS)
    except Exception:  # no result line: the run failed
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
