"""Per-step telemetry and TensorBoard scalars (JAX counterpart:
``utils/telemetry.py``) — parity with format_log_message
(reference src/utils/training_utils.py:31-57: img/s, io fetch time,
step time) and the SummaryWriter usage (create_trainer.py:76-81)."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping, Optional

from ..parallel import mesh


class StepTimer:
    """The io / step split of a train step: ``mark_io`` after the batch is
    fetched and on the device, ``mark_step`` after the step has finished;
    each interval runs from the previous mark."""

    def __init__(self):
        self._t_last = time.perf_counter()
        self.io_time = 0.0
        self.step_time = 0.0

    def mark_io(self):
        now = time.perf_counter()
        self.io_time = now - self._t_last
        self._t_last = now

    def mark_step(self):
        now = time.perf_counter()
        self.step_time = now - self._t_last
        self._t_last = now

    def throughput(self, batch_size: int) -> float:
        total = self.io_time + self.step_time
        return batch_size / total if total > 0 else 0.0


def format_log_message(
    metrics: Mapping[str, float],
    batch_size: int,
    global_step: int,
    mode: str = "train",
    log_keys=("loss",),
    timer: Optional[StepTimer] = None,
) -> str:
    parts = [f"{mode} step {global_step}"]
    for key, val in metrics.items():
        short = key.split("/")[-1]
        if any(k in key for k in log_keys) or key.startswith("acc"):
            parts.append(f"{short}: {float(val):.4f}")
    if timer is not None:
        parts.append(f"{timer.throughput(batch_size):.1f} img/s")
        parts.append(f"io: {timer.io_time * 1e3:.1f} ms")
        parts.append(f"step: {timer.step_time * 1e3:.1f} ms")
    return ", ".join(parts)


class SummaryWriter:
    """TensorBoard scalars through tensorboardX where it imports; without
    it, and on a rank other than 0, every call does nothing."""

    def __init__(self, logdir: str | Path):
        self._w = None
        if not mesh.is_main():
            return
        try:
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            pass
        else:
            self._w = TBWriter(str(logdir))

    def write(self, metrics: Mapping[str, float], step: int, prefix: str = ""):
        if self._w is None:
            return
        for key, val in metrics.items():
            self._w.add_scalar(f"{prefix}{key}", float(val), step)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
