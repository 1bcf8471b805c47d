"""A collection hook for the benchmark's tests (``benchmark/tests``).

``tests/test_bench_readers.py`` keeps a canned value for each per-layer
metric of ``BENCHMARK.json`` in ``EXPECTED``, and
``test_every_metric_has_a_canned_value`` holds that set against the file.
The neighbour search's metrics keep theirs in
``tests/test_bench_readers_knn.py``'s ``CANNED`` until they are folded into
``EXPECTED``.  Until then that test skips, with the names as its reason,
when the metrics it misses are exactly ``CANNED``'s, and runs (and fails)
when any other is missing; ``test_bench_readers_knn.py``'s test of the same
name holds the union against ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent


def _carried():
    """``CANNED``'s names, read from its module without importing it as a
    test module."""
    path = HERE / "tests" / "test_bench_readers_knn.py"
    spec = importlib.util.spec_from_file_location("_canned_knn", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return set(module.CANNED)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.name != "test_every_metric_has_a_canned_value"
                or Path(item.fspath).name != "test_bench_readers.py"):
            continue
        bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
        missing = ({m["name"] for m in bench["per_layer"]}
                   - set(item.module.EXPECTED))
        if missing and missing == _carried():
            item.add_marker(pytest.mark.skip(reason=(
                "canned values of " + ", ".join(sorted(missing))
                + " are in test_bench_readers_knn.CANNED until they are "
                "folded into EXPECTED; test_bench_readers_knn.py's "
                "test_every_metric_has_a_canned_value holds the union")))
