"""Sparse-vs-dense conv sweep, the port of ``bin/sparse_efficiency.py``.

Times the sparse engine's submanifold conv against a dense convolution of
the same grid, for dim in {2, 3} (plain 256^2 and 256^3 grids), kernel size
in {1, 3, 5} and sites drawn uniformly at random at six sparsities from
1e-4 to 10^-1.5, float32 features at 8 -> 8 channels, a capacity of 65536
sites, and writes one CSV row each:

    python -m sparseeventid_tpu_torch.scripts.sparse_efficiency \
        [--out sparse_efficiency.csv] [--size 256] [--device cuda|cpu]

The cases are drawn from ``np.random.default_rng(0)`` in the order of the
JAX tool, so both tools see the same sites, features and weights.

Sparse side: on the card the window backend (device plans: the
``window_plan`` kernel, then ``window_conv_apply`` and the batched overflow
sidecar); on the CPU the ``xla`` rulebook backend, as the JAX tool takes
off a TPU.  K = 1 is one einsum.  Plans are built outside the timed calls.
Each plan's overflow list is as wide as its candidates can be (live sites
x K), so no pair is dropped whatever the sites; each row reports
``dropped`` (0) with its list's width, the entries the sidecar walks and
the real pairs among them (at uniform random occupancy the plan windows
keep all but a few pairs: 0 to 4 a row of the default sweep).

Dense side: ``F.conv2d`` / ``F.conv3d`` with ``padding="same"`` on the
dense grid of the same sites, in float32 with TF32 off
(``models.build.fp32_convolutions``), with the JAX tool's separate dense
weights.  Each side: one warm-up call, then ``iters`` calls between two
``torch.cuda.synchronize()`` fences, timed on the host clock.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import time
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.build import fp32_convolutions
from ..ops.engine import WINDOW, XLA, apply_submanifold, plan_overflow_dropped
from ..ops.rulebook import build_submanifold_rulebook
from ..ops.sparse_tensor import SparseTensor, build_sparse_tensor, to_dense
from ..ops.window.engine import WindowPlan, build_submanifold_window_plan
from ..ops.window.kernels import _ov_bound
from ..ops.window.query import WindowTuning

DIMS = (2, 3)
KERNELS = (1, 3, 5)
SIZE = 256
CAPACITY = 65536
CHANNELS = 8  # in and out
ITERS = 5  # timed calls a side, after one warm-up
# the JAX tool's columns, in its order, then the pairs the plan dropped
COLUMNS = ("dim", "kernel", "sparsity", "nnz", "sparse_ms", "dense_ms",
           "speedup", "dropped")


def default_sparsities() -> np.ndarray:
    return np.logspace(-4, -1.5, 6)


@dataclasses.dataclass(frozen=True)
class Case:
    """One (dim, sparsity) of the sweep and the weights of each kernel size."""

    dim: int
    sparsity: float
    grid: Tuple[int, ...]
    coords: np.ndarray  # i32[n, dim], distinct sites
    feats: np.ndarray  # f32[n, CHANNELS]
    # per kernel size k: (k, sparse w f32[k^dim, C, C], dense wd
    # f32[*(k,) * dim, C, C])
    weights: Tuple[Tuple[int, np.ndarray, np.ndarray], ...]

    @property
    def n(self) -> int:
        return len(self.coords)

    def sparse_tensor(self, capacity: int, device) -> SparseTensor:
        coords = np.full((1, capacity, self.dim), -1, np.int32)
        coords[0, : self.n] = self.coords
        feats = np.zeros((1, capacity, CHANNELS), np.float32)
        feats[0, : self.n] = self.feats
        return build_sparse_tensor(torch.from_numpy(coords).to(device),
                                   torch.from_numpy(feats).to(device),
                                   self.grid)


def cases(dims: Sequence[int] = DIMS, kernels: Sequence[int] = KERNELS,
          sparsities=None, size: int = SIZE, cap: int = CAPACITY,
          seed: int = 0) -> Iterator[Case]:
    """The sweep's cases, drawn as the JAX tool draws them: per dim, per
    sparsity, the sites (``choice``) and their features; then per kernel
    size its sparse and its dense weights."""
    if sparsities is None:
        sparsities = default_sparsities()
    rng = np.random.default_rng(seed)
    for dim in dims:
        grid = (size,) * dim
        total = int(np.prod(grid))
        for sparsity in sparsities:
            n = min(cap, max(8, int(total * sparsity)))
            lin = rng.choice(total, n, replace=False).astype(np.int64)
            coords = np.stack(np.unravel_index(lin, grid), -1).astype(np.int32)
            feats = rng.standard_normal((n, CHANNELS)).astype(np.float32)
            weights = []
            for k in kernels:
                w = rng.standard_normal((k**dim, CHANNELS, CHANNELS)
                                        ).astype(np.float32)
                wd = rng.standard_normal(((k,) * dim + (CHANNELS, CHANNELS))
                                         ).astype(np.float32) * 0.1
                weights.append((k, w, wd))
            yield Case(dim, float(sparsity), grid, coords, feats,
                       tuple(weights))


def build_plan(st: SparseTensor, kernel_size, backend: str):
    """The sweep's plan: a rulebook (``xla``), or a window plan whose
    overflow list holds every candidate its live sites can give (n x K),
    so that no pair is dropped however far the neighbours lie."""
    if backend == XLA:
        return build_submanifold_rulebook(st, kernel_size)
    if backend != WINDOW:
        raise ValueError(f"unknown backend {backend!r}")
    k = int(np.prod(kernel_size))
    width = max(1, int(st.n_active.max()) * k)
    return build_submanifold_window_plan(
        st, kernel_size, window_r=WindowTuning().window_r, overflow_cap=width)


def list_occupancy(plan) -> dict:
    """Width of a window plan's overflow list, the entries the sidecar
    walks and the real pairs among them (all 0 for a rulebook)."""
    if not isinstance(plan, WindowPlan):
        return dict(list_width=0, walked=0, real_pairs=0)
    return dict(list_width=int(plan.ov_valid.shape[1]),
                walked=int(_ov_bound(plan.ov_valid).sum()),
                real_pairs=int(plan.ov_valid.sum()))


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable[[], torch.Tensor], device: torch.device,
            iters: int = ITERS):
    """-> (seconds a call, the last output): one warm-up call, then
    ``iters`` calls between two fences."""
    out = fn()
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _fence(device)
    return (time.perf_counter() - t0) / iters, out


@dataclasses.dataclass(frozen=True)
class RowRun:
    """What a row ran on, for a caller's checks (``sweep(on_row=...)``)."""

    case: Case
    kernel: int
    st: SparseTensor
    plan: object  # None at K = 1
    w: torch.Tensor  # f32[k^dim, C, C] on the device
    out: torch.Tensor  # the sparse side's output features [1, cap, C]


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "sweep on the host")
    return dev


def sweep(dims: Sequence[int] = DIMS, kernels: Sequence[int] = KERNELS,
          sparsities=None, size: int = SIZE, cap: int = CAPACITY,
          device="cuda", backend: str | None = None, iters: int = ITERS,
          on_row: Callable[[dict, RowRun], None] | None = None) -> list:
    """-> one dict a (dim, sparsity, kernel), keys ``COLUMNS``.  Runs on the
    card unless ``device="cpu"``; ``backend`` defaults to the window
    backend on the card and ``xla`` on the CPU.  ``on_row(row, run)`` is
    called after each row is timed."""
    dev = resolve_device(device)
    if backend is None:
        backend = WINDOW if dev.type == "cuda" else XLA
    if dev.type == "cuda":
        fp32_convolutions()
    rows = []
    with torch.no_grad():
        for case in cases(dims, kernels, sparsities, size, cap):
            st = case.sparse_tensor(cap, dev)
            # channels to PyTorch's place: [1, C, *grid]
            dense = to_dense(st).movedim(-1, 1).contiguous()
            conv = F.conv2d if case.dim == 2 else F.conv3d
            for k, w_np, wd_np in case.weights:
                ksz = (k,) * case.dim
                w = torch.from_numpy(w_np).to(dev)
                # [*ksz, C, CO] -> [CO, C, *ksz]
                wd = torch.from_numpy(wd_np).to(dev).permute(
                    case.dim + 1, case.dim, *range(case.dim)).contiguous()
                if k == 1:
                    plan = None

                    def sparse():
                        return torch.einsum("bnc,co->bno", st.feats, w[0])
                else:
                    plan = build_plan(st, ksz, backend)

                    def sparse():
                        return apply_submanifold(st, plan, w).feats
                dropped = int(plan_overflow_dropped(plan)) if k > 1 else 0
                sparse_s, out = time_fn(sparse, dev, iters)
                dense_s, _ = time_fn(lambda: conv(dense, wd, padding="same"),
                                     dev, iters)
                row = dict(dim=case.dim, kernel=k, sparsity=case.sparsity,
                           nnz=case.n, sparse_ms=sparse_s * 1e3,
                           dense_ms=dense_s * 1e3, speedup=dense_s / sparse_s,
                           dropped=dropped)
                print(json.dumps({**row, **list_occupancy(plan),
                                  "backend": backend if k > 1 else "einsum"}),
                      flush=True)
                rows.append(row)
                if on_row is not None:
                    on_row(row, RowRun(case, k, st, plan, w, out))
    return rows


def write_csv(rows: Sequence[dict], path) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="sparse_efficiency.csv")
    p.add_argument("--size", type=int, default=SIZE)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    rows = sweep(size=args.size, device=args.device)
    write_csv(rows, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
