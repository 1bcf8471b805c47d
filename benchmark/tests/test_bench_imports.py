"""Neither the harness nor the reference loads JAX or the JAX package;
the reference loads nothing of the program either.  Module names are
compared by their whole top-level name: the program's own name begins
with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

from tiny import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "sparseeventid_tpu"}
PROGRAM = "sparseeventid_tpu_torch"


def _top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT.parent,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_name_comparison_tells_the_program_from_the_jax_package():
    from seidbench import harness

    assert set(harness.FORBIDDEN) == JAX_SIDE
    assert harness.forbidden_loaded(
        ["sparseeventid_tpu_torch", "sparseeventid_tpu_torch.io", "jaxtyping",
         "flaxen"]) == []
    assert harness.forbidden_loaded(
        ["sparseeventid_tpu.io.larcv", "jax.numpy", "optax"]) == [
        "jax", "optax", "sparseeventid_tpu"]


def test_reference_loads_neither_jax_nor_the_program():
    loaded = _top_level_modules(
        "import seidbench.reference, seidbench.flops, seidbench.check, "
        "seidbench.generator, seidbench.trace")
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE
    assert PROGRAM not in loaded


def test_a_whole_run_loads_no_jax(tmp_path):
    loaded = _top_level_modules(
        "import sys, torch\n"
        "sys.path.insert(0, 'benchmark/tests'); sys.path.insert(0, '.')\n"
        "torch.set_num_threads(1)\n"
        "from pathlib import Path\n"
        "from tiny import tiny_spec\n"
        "from seidbench import harness\n"
        f"spec = tiny_spec(Path({str(tmp_path)!r}))\n"
        "r = harness.run_cell(spec, 5, 0.2, False, torch.device('cpu'), 0.0,"
        " log=lambda s: None)\n"
        "assert r['correct'], r['checks']\n")
    assert PROGRAM in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE
