"""The run's ``process.log`` (JAX counterpart: ``utils/logger.py``, whose
logger tees every line to ``<output_dir>/<detector>/<run.id>/process.log``):
a ``logging.FileHandler`` on the package's logger for the length of a run,
written by rank 0 alone under data parallelism."""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Iterator, Optional

from ..parallel import mesh

PACKAGE = "sparseeventid_tpu_torch"


@contextlib.contextmanager
def process_log(path: str | Path) -> Iterator[Optional[logging.Handler]]:
    """Append the package's log records (INFO and up) to ``path`` while the
    block runs; on a rank other than 0, do nothing (-> None)."""
    if not mesh.is_main():
        yield None
        return
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(p)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-8s [%(name)s] %(message)s"))
    log = logging.getLogger(PACKAGE)
    level = log.level
    if log.getEffectiveLevel() > logging.INFO:
        log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
        handler.close()
