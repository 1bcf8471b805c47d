"""Per-event cache of host-built window plans (JAX counterpart:
``io/plan_cache.py``).

A plan is a pure function of an event's coordinates and the plan geometry,
and ``io.hostio.build_window_plans`` packs every array with the batch on
its leading axis.  Training visits each event once an epoch (the
``BatchLoader``'s permutation), so the cache keeps each event's slice of
the dict from its first build and assembles later batches by
concatenation: from the second epoch on, the loader's thread builds no
plan.  ``chip_smoke.py``'s ``host_plans`` phase prints the cost of a
build and of a hit on the card's host.

Keys are (split, event index, crc32 of the event's coordinate bytes): an
event whose coordinates change between draws (an augmentation) is built
again, never served stale plans.  The byte budget is first come, first
stay: once it is full, new events are built but not stored (under uniform
reuse an LRU would evict each entry just before its next hit).
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, Sequence

import numpy as np


class PlanCache:
    def __init__(
        self,
        build_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        max_bytes: int,
    ):
        self._build = build_fn
        self.max_bytes = int(max_bytes)
        self._store: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        """Drop every stored plan and reset the counters."""
        with self._lock:
            self._store.clear()
            self._bytes = 0
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def stats_line(self) -> str:
        """One line for the trainer's log, once an epoch."""
        total = self.hits + self.misses
        rate = self.hits / total if total else 0.0
        return (
            f"plan cache: {len(self)} events, "
            f"{self._bytes / (1 << 20):.0f}/{self.max_bytes / (1 << 20):.0f} MB, "
            f"hit rate {rate:.1%} ({self.hits}/{total})"
        )

    def plans_for(
        self, split: str, coords: np.ndarray, indices: Sequence[int]
    ) -> Dict[str, np.ndarray]:
        """The plan dict of ``coords`` ([B, N, 3] i32), cached per event:
        exactly ``build_fn(coords)``, since the builder works event by event
        and slicing and concatenating along the batch axis is the
        identity."""
        idx = np.asarray(indices).ravel()
        if len(idx) != coords.shape[0]:
            raise ValueError(
                f"indices ({len(idx)}) must match batch rows "
                f"({coords.shape[0]})"
            )
        coords = np.ascontiguousarray(coords)
        keys = [
            (split, int(i), zlib.crc32(coords[p].tobytes()))
            for p, i in enumerate(idx)
        ]
        with self._lock:
            miss_pos = [p for p, k in enumerate(keys) if k not in self._store]
            self.hits += len(keys) - len(miss_pos)
            self.misses += len(miss_pos)
            fresh: Dict[int, Dict[str, np.ndarray]] = {}
            if miss_pos:
                built = self._build(np.ascontiguousarray(coords[miss_pos]))
                for row, p in enumerate(miss_pos):
                    ev = {k: v[row:row + 1] for k, v in built.items()}
                    fresh[p] = ev
                    size = sum(a.nbytes for a in ev.values())
                    if self._bytes + size <= self.max_bytes:
                        # own copies, apart from the batch-sized arrays
                        self._store[keys[p]] = {
                            k: np.ascontiguousarray(a) for k, a in ev.items()
                        }
                        self._bytes += size
            first = fresh[miss_pos[0]] if miss_pos else self._store[keys[0]]
            return {
                k: _concat([
                    fresh[p][k] if p in fresh else self._store[keys[p]][k]
                    for p in range(len(keys))
                ])
                for k in first
            }


def _concat(pieces):
    """Events' slices of one key along the batch axis.  Overflow lists built
    in different batches may differ in width (a batch with more pairs than
    a width widens its lists, ``train.plans.grown_widths``): each is padded
    to the widest with zeros, the builder's own padding (valid False)."""
    width = max(p.shape[1] for p in pieces) if pieces[0].ndim == 2 else None
    if width is not None:
        pieces = [p if p.shape[1] == width else
                  np.pad(p, ((0, 0), (0, width - p.shape[1]))) for p in pieces]
    return np.concatenate(pieces, axis=0)
