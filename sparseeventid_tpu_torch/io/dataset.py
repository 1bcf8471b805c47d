"""Batch loader with background prefetch (JAX counterpart:
``io/dataset.py``) — replaces larcv3's threaded queue_interface /
distributed_queue_interface (reference src/io/larcv_fetcher.py:59-77,
263-277): random/serial event batching with per-process sharding.

A host thread reads and assembles the next batches while the current one
trains (larcv's prepare_next, larcv_fetcher.py:403-413), filling a bounded
queue.  The index sequence is the JAX loader's for the same seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..config.schema import AccessMode


class _Failed:
    """A worker's exception, queued so that ``__next__`` raises it."""

    def __init__(self, error: BaseException):
        self.error = error


class BatchLoader:
    """Infinite iterator of batch dicts with background prefetch.

    ``dataset`` exposes ``__len__`` and ``batch(indices) -> dict``
    (SyntheticDataset or LarcvDataset).  Each process reads its own
    contiguous shard (``process_index`` of ``process_count``).  ``transform``
    runs on each batch in the worker thread.  An exception in the worker is
    raised by the next ``next()``; ``stop()`` ends the thread.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        access_mode: AccessMode = AccessMode.random_events,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        transform: Optional[Callable[[Dict], Dict]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.access_mode = access_mode
        self.transform = transform
        n = len(dataset)
        shard = np.array_split(np.arange(n), process_count)[process_index]
        if len(shard) == 0:
            shard = np.arange(n)
        self.indices = shard
        self.rng = np.random.default_rng(seed if seed >= 0 else None)
        self._cursor = 0
        # random_events: one permutation a pass, every event once an epoch
        self._perm: Optional[np.ndarray] = None
        self._perm_pos = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def __len__(self) -> int:
        return max(len(self.indices) // self.batch_size, 1)

    def _next_indices(self) -> np.ndarray:
        n = len(self.indices)
        if self.access_mode == AccessMode.serial_access:
            idx = self.indices[(self._cursor + np.arange(self.batch_size)) % n]
            self._cursor = (self._cursor + self.batch_size) % n
            return idx
        if self.access_mode == AccessMode.random_blocks:
            start = int(self.rng.integers(0, n))
            return self.indices[(start + np.arange(self.batch_size)) % n]
        # random_events: batches may straddle the epoch boundary
        out = np.empty(self.batch_size, dtype=self.indices.dtype)
        filled = 0
        while filled < self.batch_size:
            if self._perm is None or self._perm_pos >= len(self._perm):
                self._perm = self.rng.permutation(self.indices)
                self._perm_pos = 0
            take = min(self.batch_size - filled, len(self._perm) - self._perm_pos)
            out[filled:filled + take] = self._perm[self._perm_pos:self._perm_pos + take]
            self._perm_pos += take
            filled += take
        return out

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.dataset.batch(self._next_indices())
                if self.transform is not None:
                    batch = self.transform(batch)
            except Exception as e:  # handed to the consumer, which raises it
                self._put(_Failed(e))
                return
            self._put(batch)

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        item = self._q.get()
        if isinstance(item, _Failed):
            raise RuntimeError("batch loader worker failed") from item.error
        return item

    def stop(self) -> None:
        """End the worker thread (after the batch it is making) and drop the
        prefetched batches."""
        self._stop.set()
        self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()
