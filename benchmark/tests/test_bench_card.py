"""On the card: one short run of each cell through the command, its last
line parsed and ``correct`` true.  Run them on a machine with a card:

    python -m pytest benchmark/tests -q -m card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from tiny import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_no_card_no_result(tmp_path):
    """Without a card (or in a directory without the program) the command
    exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
