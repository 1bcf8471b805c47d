"""Per-step telemetry and TensorBoard scalars (JAX counterpart:
``utils/telemetry.py``) — parity with format_log_message
(reference src/utils/training_utils.py:31-57: img/s, io fetch time,
step time) and the SummaryWriter usage (create_trainer.py:76-81) — and
the program's tracer.

The tracer records where the host's time goes: ``span(name)`` around a
piece of host work, ``count(name, n)`` where something happens.  Both do
nothing until ``tracing()`` turns recording on for a block (the
benchmark's traced run, and ``run.profile``); off, a span is one read of
a module global and a shared no-op context manager: no allocation, no
clock read, no lock.  On, each span is kept in memory as a ``Span``
(name, thread, start and end by ``time.perf_counter_ns``, its parent on
the same thread, its step) and each count is added to the innermost span
open on the thread that counted, or, on a thread with none open (the
autograd engine's device thread), to the innermost span open on the
thread that turned tracing on.  While it records, and CUDA is in use,
every synchronizing CUDA operation the host makes
(``torch.cuda.set_sync_debug_mode("warn")``) is counted as
``host_syncs``, each time it happens.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from pathlib import Path
from time import perf_counter_ns
from typing import Dict, List, Mapping, NamedTuple, Optional

import torch

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


SYNC_WARNING = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    """One recorded span: ``end_ns`` is None for a span still open when
    recording stopped; ``parent`` is the index of the enclosing span on
    the same thread (-1: none); ``step`` the number of step-opening spans
    (``span(..., new_step=True)``) begun before it, less one, on any
    thread: a loader thread's work is counted in the step during which it
    began, not the one whose batch it makes."""

    name: str
    thread: int
    start_ns: int
    end_ns: Optional[int]
    parent: int
    step: int


class Count(NamedTuple):
    """A counter's total within one span (``span``: the span's index,
    -1 when no span was open)."""

    name: str
    span: int
    n: int


class _Off:
    """The one span handed out while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_tracer: Optional["Tracer"] = None


def span(name: str, new_step: bool = False):
    """A context manager around host work named ``name``; ``new_step``: a
    new step begins with it."""
    tracer = _tracer
    if tracer is None:
        return _OFF
    return _OpenSpan(tracer, name, new_step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` in the innermost open span."""
    tracer = _tracer
    if tracer is not None:
        tracer.count(name, n)


def recording() -> bool:
    """True while a ``tracing()`` block records: a count that costs work
    to compute is computed only then."""
    return _tracer is not None


class Tracer:
    """What one ``tracing()`` block records.  ``spans``, ``counts`` and
    ``threads`` (thread ident -> name) are filled when the block ends;
    ``main`` is the ident of the thread that began it."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.main = threading.get_ident()
        self.spans: List[Span] = []
        self.counts: List[Count] = []
        self.threads: Dict[int, str] = {}
        self._records: List[list] = []
        self._stacks: Dict[int, List[int]] = {}
        self._totals: Dict[tuple, int] = {}
        self._step = -1
        self._lock = threading.Lock()

    def count(self, name: str, n: int = 1) -> None:
        stack = (self._stacks.get(threading.get_ident())
                 or self._stacks.get(self.main) or ())
        top = stack[-1:]  # a slice: the owning thread may pop meanwhile
        key = (name, top[0] if top else -1)
        with self._lock:
            self._totals[key] = self._totals.get(key, 0) + n

    def _open(self, name: str, new_step: bool) -> int:
        ident = threading.get_ident()
        stack = self._stacks.get(ident)
        if stack is None:
            stack = self._stacks[ident] = []
            self.threads[ident] = threading.current_thread().name
        with self._lock:
            if new_step:
                self._step += 1
            index = len(self._records)
            self._records.append([name, ident, 0, None,
                                  stack[-1] if stack else -1, self._step])
        stack.append(index)
        return index

    def _close(self, index: int, end_ns: int) -> None:
        self._records[index][3] = end_ns
        self._stacks[threading.get_ident()].pop()

    def _freeze(self) -> None:
        with self._lock:
            self.spans = [Span(*r) for r in self._records]
            self.counts = [Count(name, s, n)
                           for (name, s), n in self._totals.items()]


class _OpenSpan:
    __slots__ = ("tracer", "name", "new_step", "index", "range")

    def __init__(self, tracer: Tracer, name: str, new_step: bool):
        self.tracer, self.name, self.new_step = tracer, name, new_step
        self.range = None

    def __enter__(self):
        tracer = self.tracer
        self.index = tracer._open(self.name, self.new_step)
        if tracer.profile:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        tracer._records[self.index][2] = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        self.tracer._close(self.index, end)
        return False


@contextlib.contextmanager
def tracing(profile: bool = False):
    """Record the program's spans and counts for the block -> the
    ``Tracer``, whose records are there once the block ends.  With
    ``profile`` each span also opens a ``torch.profiler.record_function``
    range of its name (``run.profile``'s trace).  One block at a time."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("the tracer is already recording")
    tracer = Tracer(profile)
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                tracer.count("host_syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = show
        mode = None
        if torch.cuda.is_initialized():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _tracer = tracer
        try:
            yield tracer
        finally:
            _tracer = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            tracer._freeze()
