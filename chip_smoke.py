#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sparseeventid_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. device   the card's name, count, and nvidia-smi's name and power limit
  2. build    every CUDA kernel of csrc/ built with nvcc (sm_90a), in parallel
  3. kernel   each kernel, forward and backward, against its plain PyTorch
              version on the card, at the main path's shapes from one
              synthetic dune3d batch: bit-equal on integer-valued bf16 data
              (the sidecar and window_dw on fp32 too; the sidecar also on
              hand-made lists at the real list width: a row of K entries
              across a span edge, holes, an empty event, n_bound below the
              width), max abs error on real-valued data, and times (kernel,
              plain version, a PyTorch yardstick) beside the card's least
              time
  4. grad     conv-level gradients on integer-valued fp32 data: dX and dW
              of the window autograd Functions equal the plain rulebook
              backend's autograd exactly (level-0 series plan and level-0
              downsample plans, the latter also with a reverse window
              narrow enough to fill the reverse list), and two planted
              faults of the backward's overflow complement are caught
  5. main     full-width dune3d inference (B=8, 50k-voxel cap, depth 5,
              filters 32->192, bf16) through train.evaluate.validate:
              finite loss and softmax, no dropped pairs, every forward
              kernel launched and no plain version called; a profiled batch
  6. train    the supervised train step at the same width through
              train.trainer.train (bf16, dropout on): one warm-up and three
              timed steps; finite loss, no dropped pairs, a finite gradient
              on every parameter and a non-zero one on every conv weight,
              running statistics moved, the launch counts of every kernel
              as expected; a profiled step
  7. fp32     one batch at fp32, window kernels against the plain rulebook
              backend on the card: forward features and logits, then every
              parameter gradient of one train step; each check must also
              catch two planted faults of the overflow sidecars
  8. gather   window_gather (the deconv's shape and the level-0 series
              shape) bit-equal to its plain version on real-valued bf16
              data, gather_conv (levels 0 and 5 over the real rulebooks)
              bit-equal on integer-valued data; the deconv's two-step dW
              timed beside window_dw at the same shape, and window_dw's
              own row there (bit-equal on integer bf16 and fp32 data)
  9. engine_ops  integer-valued fp32: the window deconv (forward, dX, dW)
              against the plain backend's autograd, PoolingDownsample's
              window branch against its plain branch, the gather conv
              against the plain conv's autograd, all exact, and two planted
              faults caught; then ConvolutionUpsample and the gather conv
              driven forward and backward at full width in bf16 (ops_path)
 10. main2d / train2d  the dune2d multiplane model (3 planes of 1536 x 1024,
              B=8, bf16, depth 5) through the same validate and train entry
              points, with the same checks and launch counts; the kernel
              phase also runs at the dune2d shapes (K = 25, 9, 4)
 11. the {"kernels": [...]} line, then {"ok": true, "device": {...}} last.

It needs the repository around it and a CUDA device: without either it
prints no result and exits with 2.  Kernels build into build/torch_kernels/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
GRID = (1024, 512, 1280)
BATCH = 8
MAX_VOXELS = 50000
N_BATCHES = 3
SEED = 0
# dune2d: plane axis first; events are 3D tracks on (H, H, W) projected per
# plane, at the occupancy of the JAX package's dune2d bench file
GRID_2D = (3, 1536, 1024)
MAX_VOXELS_2D = 20000  # a plane
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

REPLACES = {
    "window_plan": "sparseeventid_tpu/ops/pallas/window_conv.py:607",
    "window_conv_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:993",
    "overflow_apply_batched": "sparseeventid_tpu/ops/pallas/window_sidecar.py:266",
    "overflow_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:1783",
    "window_bwd_strided": "sparseeventid_tpu/ops/pallas/window_conv.py:1506",
    "window_dw": "sparseeventid_tpu/ops/pallas/window_conv.py:1264",
    "overflow_dw_batched": "sparseeventid_tpu/ops/pallas/window_sidecar.py:377",
    "overflow_dw": "sparseeventid_tpu/ops/pallas/window_conv.py:1881",
    "window_gather": "sparseeventid_tpu/ops/pallas/window_conv.py:1608",
    "gather_conv": "sparseeventid_tpu/ops/pallas/gather_conv.py:62",
}
SOURCES = {
    "window_plan": "sparseeventid_tpu_torch/csrc/window_plan.cu",
    "window_conv_apply": "sparseeventid_tpu_torch/csrc/window_conv.cu",
    "overflow_apply_batched": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
    "overflow_apply": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
    "window_bwd_strided": "sparseeventid_tpu_torch/csrc/window_bwd.cu",
    "window_dw": "sparseeventid_tpu_torch/csrc/window_dw.cu",
    "overflow_dw_batched": "sparseeventid_tpu_torch/csrc/overflow_dw.cu",
    "overflow_dw": "sparseeventid_tpu_torch/csrc/overflow_dw.cu",
    "window_gather": "sparseeventid_tpu_torch/csrc/window_gather.cu",
    "gather_conv": "sparseeventid_tpu_torch/csrc/gather_conv.cu",
}
# kernels no model of the package selects: their path is the ops_path drive
OPS_KERNELS = ("window_gather", "gather_conv")
# kernels the inference path launches (it must launch no other); the rest
# only the train step does
FORWARD_KERNELS = ("window_plan", "window_conv_apply", "overflow_apply_batched",
                   "overflow_apply")
# launches per train step, dune3d and dune2d alike: 17 plans (1 initial + 6 series + 5 x 2
# strided), 54 convs (1 + 48 + 5), each with a forward sidecar; the backward
# runs the fused kernel for the 53 convs with C > 1 and window_dw for the
# initial one, a dX sidecar for the 53 (the image needs no gradient) and a
# dW sidecar for all 54
LAUNCHES_PER_TRAIN_STEP = {
    "window_plan": 17, "window_conv_apply": 54, "overflow_apply_batched": 106,
    "overflow_apply": 1, "window_bwd_strided": 53, "window_dw": 1,
    "overflow_dw_batched": 53, "overflow_dw": 1,
}
# launches of the ops_path drive.  ConvolutionUpsample (64 -> 32 channels)
# forward and backward: the forward and the reverse plan; the forward conv
# over the reverse plan and dX over the forward plan, each with its sidecar;
# dW by window_gather and the batched dW sidecar.  gather_submanifold_conv:
# the forward and dX are the same kernel.  Nothing else launches.
OPS_PATH_LAUNCHES = {
    "window_plan": 2, "window_conv_apply": 2, "overflow_apply_batched": 2,
    "overflow_apply": 0, "window_bwd_strided": 0, "window_dw": 0,
    "overflow_dw_batched": 1, "overflow_dw": 0,
    "window_gather": 1, "gather_conv": 2,
}
TRAIN_STEPS = 4  # one warm-up, three timed
FP32_GRAD_EVENTS = 2  # the plain backend's fp32 backward keeps ~7 GB an event


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise Failure(what)


def timed_ms(fn, iters: int = 10, warmup: int = 2, graph: bool = True) -> float:
    """Mean device time of one call.  ``graph``: ``iters`` calls captured in
    one CUDA graph, replayed between two CUDA events, so the host's cost of
    a launch (the Python wrapper, ctypes) is left out and a call of a few
    microseconds is timed as the device runs it.  Otherwise (the plain
    versions, which synchronise): CUDA events around ``iters`` calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    if graph:
        g.replay()
    else:
        for _ in range(iters):
            fn()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class CachedDataset:
    """Pre-generated padded batches (keyed by their first index) with the
    dataset interface validate() reads, so event generation stays out of
    the timed run."""

    def __init__(self, grid, batches: dict, n_events: int):
        self._grid = tuple(grid)
        self._batches = batches
        self.n = n_events

    def __len__(self):
        return self.n

    def batch_grid(self):
        return self._grid

    def batch(self, indices):
        return self._batches[indices[0]]


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi_line


def phase_build():
    from sparseeventid_tpu_torch.ops.window import _native

    t0 = time.perf_counter()
    reports = _native.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in reports.items()
    }
    for name in _native.SOURCES:
        _native.lib(name)  # load: raises if a library is missing
    emit({"phase": "build", "seconds": seconds, "built": sorted(reports),
          "ptxas": ptxas})


def make_dataset():
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig

    n = BATCH * N_BATCHES
    ds = SyntheticDataset(
        n,
        SyntheticEventConfig(image_size=GRID, max_voxels=MAX_VOXELS,
                             mean_tracks=75.0, steps_per_track=900),
        seed=SEED,
    )
    batches = {i: ds.batch(list(range(i, i + BATCH))) for i in range(0, n, BATCH)}
    return CachedDataset(GRID, batches, n)


def make_dataset_2d():
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig

    n = BATCH * N_BATCHES
    h, w = GRID_2D[1:]
    ds = SyntheticDataset(
        n,
        SyntheticEventConfig(image_size=(h, h, w), n_planes=GRID_2D[0],
                             max_voxels=MAX_VOXELS_2D, mean_tracks=40.0,
                             steps_per_track=900),
        seed=SEED,
    )
    batches = {i: ds.batch(list(range(i, i + BATCH))) for i in range(0, n, BATCH)}
    return CachedDataset(GRID_2D, batches, n)


# the two geometries of the kernel phase
# (prefix: put before the labels of the rows)
GEOMETRY_3D = dict(grid=GRID, rows=MAX_VOXELS, stride=(2, 2, 2),
                   to_sparse="larcv_batch_to_sparse_3d", prefix="",
                   initial=(5, 5, 5), series=(3, 3, 3))
GEOMETRY_2D = dict(grid=GRID_2D, rows=MAX_VOXELS_2D * GRID_2D[0],
                   stride=(1, 2, 2), to_sparse="larcv_batch_to_sparse_2d",
                   prefix="2d ", initial=(1, 5, 5), series=(1, 3, 3))


def _kname(ksz) -> str:
    if len(set(ksz)) == 1:
        return f"{ksz[0]}^{len(ksz)}"
    return "x".join(str(k) for k in ksz)


def _int_like(shape, gen, device, dtype, lo=-2, hi=3):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device=device).to(dtype)


def _handmade_lists(n_q, n_t, k, width, seed):
    """Overflow lists the engine rarely builds, at a real list's width, for
    the sidecar kernel's row-aligned spans (32 entries at C * CO <= 1024,
    csrc/overflow_apply.cu) -> (src, dst, kk, valid, n_bound) on the card.
    Per event, rows ascend with 1..K entries each (distinct offsets) and 10%
    of the prefix are invalid holes (dst kept in order); in event 0 a row of
    all K offsets starts at entry max(0, 32 - K // 2), across a span edge;
    every third event is empty (n_bound 0); past each prefix lie garbage
    entries, half of them flagged valid, with indices out of every range,
    and n_bound (< width) stops before them.  n_q, n_t: live output and
    table rows per event."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = len(n_q)
    src = rng.integers(-9, 2**20, (b, width))
    dst = rng.integers(-9, 2**20, (b, width))
    kk = rng.integers(-3, 4 * k, (b, width))
    valid = rng.random((b, width)) < 0.5
    n_bound = np.zeros(b, np.int64)
    for e in range(b):
        if e % 3 == 2:
            continue
        rows = np.sort(rng.choice(n_q[e], min(n_q[e], width // k), replace=False))
        runs = rng.integers(1, k + 1, rows.size)
        if e == 0:
            lead = max(0, 32 - k // 2)  # single-entry rows up to the K-row
            runs[:lead], runs[lead] = 1, k
        p = int(runs.sum())
        dst[e, :p] = np.repeat(rows, runs)
        kk[e, :p] = np.concatenate([rng.permutation(k)[:r] for r in runs])
        src[e, :p] = rng.integers(0, n_t[e], p)
        valid[e, :p] = rng.random(p) >= 0.1
        n_bound[e] = p
    dev = torch.device(DEVICE)
    return tuple(torch.as_tensor(a, device=dev).to(t).contiguous() for a, t in (
        (src, torch.int32), (dst, torch.int32), (kk, torch.int32),
        (valid, torch.bool), (n_bound, torch.int32)))


def phase_kernels(dataset, geo=GEOMETRY_3D):
    """Kernel against plain version at main-path shapes -> per-kernel rows."""
    import torch

    from sparseeventid_tpu_torch import io as port_io
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q
    from sparseeventid_tpu_torch.ops.window.engine import _mirror_perm
    from sparseeventid_tpu_torch.ops.window.sidecar import (
        overflow_apply_batched,
        overflow_dw_batched,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    caps = capacity_schedule(geo["rows"], 5, 0.5, 1024)
    bf16 = torch.bfloat16
    stride, pre = geo["stride"], geo["prefix"]
    st0 = getattr(port_io, geo["to_sparse"])(
        dataset.batch([0])["image"], geo["grid"], capacity=caps[0], device=dev)
    # site sets of every level (the downsample chain)
    levels = [st0]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], stride, cap))
    tuning = Q.WindowTuning()

    def rows_of(st, c):
        return torch.where(
            st.row_mask()[..., None],
            torch.ones((*st.row_mask().shape, c), device=dev, dtype=bf16), 0,
        )

    def int_feats(st, c):
        return (_int_like((st.batch_size, st.capacity, c), gen, dev, bf16)
                * rows_of(st, c)).contiguous()

    def real_feats(st, c):
        x = torch.randn((st.batch_size, st.capacity, c), generator=gen, device=dev)
        return (x.to(bf16) * rows_of(st, c)).contiguous()

    def real_w(k, c, co):
        w = torch.randn((k, c, co), generator=gen, device=dev) / (k * c) ** 0.5
        return w.to(bf16).contiguous()

    k_init, k_ser = geo["initial"], geo["series"]
    # (label, table st, ksz, strided, window_r, C, CO, sidecars): the
    # overflow sidecars are held against their plain versions on the lists
    # of the initial conv (the C == 1 entries) and of the level-0 series
    # (the batched entries); both lists must be non-empty
    cases = [
        (f"{pre}initial {_kname(k_init)} 1->32", st0, k_init, False,
         tuning.window_r_initial, 1, 32, True),
        (f"{pre}L0 series {_kname(k_ser)} 32->32", st0, k_ser, False,
         tuning.for_level(0), 32, 32, True),
        (f"{pre}L5 series {_kname(k_ser)} 192->192", levels[5], k_ser, False,
         tuning.for_level(5), 192, 192, False),
        (f"{pre}L0 downsample {_kname(stride)} 32->64", st0, stride, True,
         tuning.window_r_strided, 32, 64, False),
    ]

    results = {n: [] for n in REPLACES if n not in OPS_KERNELS}
    for label, tab, ksz, strided, r, c, co, sidecars in cases:
        # the plan as the main path builds it (ops.engine), list included
        if strided:
            qst, (plan, rev), _ = E.build_downsample_plan(
                tab, ksz, caps[1], backend=E.WINDOW, tuning=tuning)
        else:
            qst, plan = tab, E.build_series_plan(tab, ksz, backend=E.WINDOW,
                                                 window_r=r)
            rev = None
        require(plan.window_r == r, f"plan window {plan.window_r} at {label}")
        offs = rb.kernel_offsets(ksz, centered=not strided)
        keys = tab.keys()
        if strided:
            qkeys = Q.compute_strided_query_keys(qst, tab.grid_shape, ksz, offs)
            full = rb.build_downsample_rulebook(tab, qst, ksz)
        else:
            qkeys = Q.compute_query_keys(qst, offs)
            full = rb.build_submanifold_rulebook(tab, ksz)
        pk = Q._padded_table(keys)
        k = len(offs)
        # rows this run's data touches: active table rows, live query rows
        n_tab = int(tab.n_active.sum())
        n_q = int(qst.n_active.sum())
        live_tiles = int(((qst.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())

        # ---- window_plan: bit-equal on the real site sets
        args = (pk, qkeys, qst.n_active)
        start, uncov = K.window_plan(*args, window_r=r, table_cap=tab.capacity)
        start_p, uncov_p = K.window_plan_plain(*args, window_r=r,
                                               table_cap=tab.capacity)
        torch.cuda.synchronize()
        require(torch.equal(start, start_p) and torch.equal(uncov, uncov_p),
                f"window_plan differs from its plain version at {label}")
        require(torch.equal(start, plan.start),
                f"window_plan differs from the engine's plan at {label}")
        ms = timed_ms(lambda: K.window_plan(*args, window_r=r,
                                            table_cap=tab.capacity))
        plain_ms = timed_ms(lambda: K.window_plan_plain(
            *args, window_r=r, table_cap=tab.capacity), iters=3, warmup=1,
            graph=False)
        qf = qkeys.reshape(qkeys.shape[0], -1)
        lib_ms = timed_ms(lambda: torch.searchsorted(keys, qf))
        # reads: the active keys, the live queries' keys; writes: start and
        # uncovered in full (the function defines every entry)
        b_ms, b_by = bound(
            4 * n_tab + 4 * k * n_q + nbytes(qst.n_active, start, uncov), 0)
        candidates = uncov.ne(0).sum(dim=(1, 2))
        results["window_plan"].append(dict(
            shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            uncovered=int(candidates.sum()),
        ))

        # the plan's overflow list, as the engine compacted it
        src, dst, kk, valid = plan.ov_src, plan.ov_dst, plan.ov_k, plan.ov_valid
        require(int(plan.ov_dropped.sum()) == 0, f"overflow list clamped at {label}")
        n_ov = int(valid.sum())
        pairs_total = int(full.hit.sum())
        pairs_in = pairs_total - n_ov
        occupancy = {
            "list_width": valid.shape[1],
            "candidates_max_per_event": int(candidates.max()),
            "real_pairs_max_per_event": int(valid.sum(dim=1).max()),
        }

        # ---- window_conv_apply: bit-equal on integer data
        w_int = _int_like((k, c, co), gen, dev, bf16)
        x_int = int_feats(tab, c)
        cargs = (keys, x_int, plan.qmeta, start, w_int, qst.n_active, plan.dkeys)
        out = K.window_conv_apply(*cargs, window_r=r)
        out_p = K.window_conv_apply_plain(*cargs, window_r=r)
        torch.cuda.synchronize()
        require(torch.equal(out, out_p),
                f"window_conv_apply differs from its plain version at {label}")
        x_real, w_real = real_feats(tab, c), real_w(k, c, co)
        rargs = (keys, x_real, plan.qmeta, start, w_real, qst.n_active,
                 plan.dkeys)
        err = (K.window_conv_apply(*rargs, window_r=r).float()
               - K.window_conv_apply_plain(*rargs, window_r=r).float()
               ).abs().max().item()
        ms = timed_ms(lambda: K.window_conv_apply(*rargs, window_r=r))
        plain_ms = timed_ms(lambda: K.window_conv_apply_plain(*rargs, window_r=r),
                            iters=3, warmup=1, graph=False)
        # yardstick: index gather of every rulebook neighbour + one matmul
        idx = full.neighbor_idx.long().reshape(tab.batch_size, -1)
        hit = full.hit.reshape(tab.batch_size, -1, 1)
        w2 = w_real.reshape(k * c, co)

        def library():
            g = torch.gather(x_real, 1, idx[..., None].expand(-1, -1, c))
            g = (g * hit).reshape(tab.batch_size, qst.capacity, k * c)
            return torch.matmul(g, w2)

        lib_ms = timed_ms(library)
        # reads: keys and features of the active table rows, the live
        # queries' meta, the live tiles' starts, W; writes: the output in
        # full (rows past the live ones are defined as 0)
        nw1 = plan.qmeta.shape[1]
        b_ms, b_by = bound(
            (4 + 2 * c) * n_tab + 4 * nw1 * n_q + 4 * k * live_tiles
            + nbytes(qst.n_active, w_real, out),
            2.0 * pairs_in * c * co,
        )
        results["window_conv_apply"].append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            pairs_in_window=pairs_in,
        ))

        # ---- sidecar on this plan's overflow list (C == 1: serial entry)
        name = "overflow_apply" if c == 1 else "overflow_apply_batched"
        if sidecars:
            require(n_ov > 0, f"the overflow list is empty at {label}")
            nb = K._ov_bound(valid)
            # the kernel's precondition (csrc/overflow_apply.cu)
            require(K.overflow_dst_ordered(dst, nb),
                    f"the overflow list's dst is out of order at {label}")
            plan_list = (src, dst, kk, valid, nb)

            def side(base, x, w, kernel=True, lst=plan_list):
                sargs = (base, x, w, *lst)
                if not kernel:
                    return K.overflow_apply_plain(*sargs)
                if c == 1:
                    return K.overflow_apply(*sargs)
                return overflow_apply_batched(*sargs)

            hand = _handmade_lists(qst.n_active.tolist(), tab.n_active.tolist(),
                                   k, src.shape[1], SEED + c)
            require(K.overflow_dst_ordered(hand[1], hand[4])
                    and int(hand[4].max()) < src.shape[1],
                    f"hand-made lists are not as meant at {label}")
            for what, lst in (("the plan's list", plan_list),
                              ("hand-made lists", hand)):
                for dt in (bf16, torch.float32):
                    args_dt = (out.to(dt), x_int.to(dt), w_int.to(dt))
                    got = side(args_dt[0].clone(), *args_dt[1:], lst=lst)
                    want = side(args_dt[0].clone(), *args_dt[1:], kernel=False,
                                lst=lst)
                    torch.cuda.synchronize()
                    require(torch.equal(got, want),
                            f"{name} differs from its plain version on {what}, "
                            f"{dt}, at {label}")
                    require(not torch.equal(got, args_dt[0]),
                            f"{name} changed nothing on {what} at {label}")
            walked = (torch.arange(src.shape[1], device=dev)[None, :]
                      < hand[4][:, None])
            occupancy["handmade_entries"] = int((hand[3] & walked).sum())
            base_r = K.window_conv_apply(*rargs, window_r=r)
            err = (side(base_r.clone(), x_real, w_real).float()
                   - side(base_r.clone(), x_real, w_real, kernel=False).float()
                   ).abs().max().item()
            scratch = base_r.clone()
            ms = timed_ms(lambda: side(scratch, x_real, w_real))
            plain_ms = timed_ms(lambda: side(scratch, x_real, w_real, False),
                                iters=3, warmup=1, graph=False)
            bi, si = torch.nonzero(valid, as_tuple=True)
            target = bi * qst.capacity + dst[bi, si].long()
            source = bi * tab.capacity + src[bi, si].long()
            rows = x_real[bi, src[bi, si].long()]
            wk = w_real[kk[bi, si].long()]
            flat = scratch.view(-1, co)

            def library():
                contrib = torch.bmm(rows[:, None, :], wk)[:, 0]
                flat.index_add_(0, target, contrib)

            lib_ms = timed_ms(library)
            # reads: the valid flags of the walked prefix, (src, dst, k) of
            # the valid entries, each distinct source row once, W; each
            # distinct output row is read and written once (in place)
            b_ms, b_by = bound(
                int(nb.sum()) + 12 * n_ov + nbytes(nb, w_real)
                + 2 * c * int(torch.unique(source).numel())
                + 2 * 2 * co * int(torch.unique(target).numel()),
                2.0 * n_ov * c * co,
            )
            results[name].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                entries=n_ov, walked=int(nb.sum()),
            ))
        # ---- backward kernels.  gy lives on the OUTPUT sites (qst).
        gy_int = int_feats(qst, co)
        gy_real = real_feats(qst, co)
        nbr = full.neighbor_idx.long()  # [B, M, K] rows of tab per output row
        hit4 = full.hit[..., None]
        flat_rows = (nbr + torch.arange(tab.batch_size, device=dev)[:, None, None]
                     * tab.capacity).reshape(-1)

        def library_bwd(x, gy, w, want_dx=True):
            """PyTorch formulation over the full rulebook: one gather and
            one contraction for dW; one contraction and one index_add_ for
            dX."""
            xg = torch.gather(
                x, 1, nbr.reshape(tab.batch_size, -1, 1).expand(-1, -1, c)
            ).reshape(*nbr.shape, c) * hit4
            dw = torch.einsum("bmkc,bmo->kco", xg, gy)
            if not want_dx:
                return dw
            dxk = torch.einsum("bmo,kco->bmkc", gy, w) * hit4
            dx = torch.zeros((tab.batch_size * tab.capacity, c), dtype=x.dtype,
                             device=dev)
            return dx.index_add_(0, flat_rows, dxk.reshape(-1, c)), dw

        nw1 = plan.qmeta.shape[1]
        if c > 1:
            # kernel 5: the fused backward.  Submanifold: window_bwd_subm on
            # the forward plan; strided: window_bwd_strided on the reverse
            # plan (queries are the INPUT rows, the table is gy's).
            bp = rev if strided else plan
            perm = None if strided else _mirror_perm(plan.offsets)
            bkeys = qst.keys()

            perm_t = None if strided else torch.as_tensor(perm, device=dev)

            def fused(x, gy, w, kernel=True):
                wk = w if strided else w[perm_t].contiguous()
                f = K.window_bwd_strided if kernel else K.window_bwd_strided_plain
                return f(bkeys, gy, x, bp.qmeta, bp.start, wk, bp.q_active,
                         bp.dkeys, window_r=bp.window_r)

            before = K.window_bwd_strided.launches
            if not strided:  # the thin call the engine makes
                got = K.window_bwd_subm(
                    bkeys, x_int, gy_int, bp.qmeta, bp.start, w_int,
                    bp.q_active, perm, bp.dkeys, window_r=bp.window_r)
            else:
                got = fused(x_int, gy_int, w_int)
            require(K.window_bwd_strided.launches == before + 1,
                    "window_bwd_strided did not count its launch")
            want = fused(x_int, gy_int, w_int, kernel=False)
            torch.cuda.synchronize()
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"window_bwd_strided differs from its plain version at {label}")
            require(float(got[1].abs().sum()) > 0, f"dw is all 0 at {label}")
            rk, rp = fused(x_real, gy_real, w_real), fused(x_real, gy_real,
                                                           w_real, False)
            err = max((rk[0].float() - rp[0].float()).abs().max().item(),
                      (rk[1] - rp[1]).abs().max().item())
            ms = timed_ms(lambda: fused(x_real, gy_real, w_real))
            plain_ms = timed_ms(lambda: fused(x_real, gy_real, w_real, False),
                                iters=2, warmup=1, graph=False)
            lib_ms = timed_ms(lambda: library_bwd(x_real, gy_real, w_real),
                              iters=3, warmup=1)
            # in-window pairs of the plan the kernel walks
            n_rev_ov = int(bp.ov_valid.sum())
            pairs_bwd = pairs_total - n_rev_ov
            rows_x = int(tab.n_active.sum())  # query side: the input rows
            rows_gy = int(qst.n_active.sum())
            tiles_x = int(((tab.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())
            # reads: keys and gy of the active gy rows, x and meta of the
            # live input rows, the live tiles' starts, W; writes: dx in
            # full (dead rows are defined as 0) and dw
            b_ms, b_by = bound(
                (4 + 2 * co) * rows_gy
                + (2 * c + 4 * bp.qmeta.shape[1]) * rows_x + 4 * k * tiles_x
                + nbytes(bp.q_active, w_real, rk[0], rk[1]),
                4.0 * pairs_bwd * c * co,
            )
            results["window_bwd_strided"].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                pairs_in_window=pairs_bwd,
                entry="window_bwd_strided" if strided else "window_bwd_subm",
            ))
        else:
            # kernel 6: window_dw over the forward plan (the initial conv)
            # the persistent grid must stride: more live tiles than blocks
            parts = K._dw_parts(dev, tab.batch_size, qst.capacity, k, c, co)
            require(live_tiles > parts,
                    f"{live_tiles} live tiles, {parts} window_dw blocks at {label}")
            for dt in (bf16, torch.float32):
                dargs = (keys, x_int.to(dt), plan.qmeta, start, gy_int.to(dt),
                         qst.n_active, plan.dkeys)
                got = K.window_dw(*dargs, window_r=r)
                want = K.window_dw_plain(*dargs, window_r=r)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"window_dw differs from its plain version, {dt}, at {label}")
                require(float(got.abs().sum()) > 0, f"dw is all 0 at {label}")
            rargs_dw = (keys, x_real, plan.qmeta, start, gy_real, qst.n_active,
                        plan.dkeys)
            err = (K.window_dw(*rargs_dw, window_r=r)
                   - K.window_dw_plain(*rargs_dw, window_r=r)).abs().max().item()
            ms = timed_ms(lambda: K.window_dw(*rargs_dw, window_r=r))
            plain_ms = timed_ms(lambda: K.window_dw_plain(*rargs_dw, window_r=r),
                                iters=2, warmup=1, graph=False)
            lib_ms = timed_ms(
                lambda: library_bwd(x_real, gy_real, w_real, want_dx=False),
                iters=3, warmup=1)
            b_ms, b_by = bound(
                (4 + 2 * c) * n_tab + (4 * nw1 + 2 * co) * n_q
                + 4 * k * live_tiles + nbytes(qst.n_active, got),
                2.0 * pairs_in * c * co,
            )
            results["window_dw"].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                pairs_in_window=pairs_in, live_tiles=live_tiles, blocks=parts,
            ))

        # ---- dW sidecar on the list the backward walks: the forward list
        # with src and dst swapped for the fused submanifold backward, the
        # forward list as it is for C == 1
        dname = "overflow_dw" if c == 1 else "overflow_dw_batched"
        if sidecars:
            nb = K._ov_bound(valid)
            s_, d_ = (src, dst) if c == 1 else (dst, src)

            def side_dw(x, gy, kernel=True):
                sargs = (x, gy, k, s_, d_, kk, valid, nb)
                if not kernel:
                    return K.overflow_dw_plain(*sargs)
                return K.overflow_dw(*sargs) if c == 1 else overflow_dw_batched(*sargs)

            got = side_dw(x_int, gy_int)
            want = side_dw(x_int, gy_int, kernel=False)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"{dname} differs from its plain version at {label}")
            require(float(got.abs().sum()) > 0,
                    f"sidecar dw is all 0 at {label}")
            err = (side_dw(x_real, gy_real)
                   - side_dw(x_real, gy_real, False)).abs().max().item()
            ms = timed_ms(lambda: side_dw(x_real, gy_real))
            plain_ms = timed_ms(lambda: side_dw(x_real, gy_real, False),
                                iters=3, warmup=1, graph=False)
            bi, si = torch.nonzero(valid, as_tuple=True)
            xs = x_real[bi, s_[bi, si].long()]
            gs = gy_real[bi, d_[bi, si].long()]
            kidx = kk[bi, si].long()
            acc = torch.zeros((k, c, co), dtype=torch.float32, device=dev)

            def library_dw():
                acc.index_add_(0, kidx, (xs[:, :, None] * gs[:, None, :]).float())

            lib_ms = timed_ms(library_dw)
            xrows = bi * tab.capacity + s_[bi, si].long()
            grows = bi * qst.capacity + d_[bi, si].long()
            # reads: the valid flags of the walked prefix, (src, dst, k) of
            # the valid entries, each distinct x and gy row once; writes dw
            b_ms, b_by = bound(
                int(nb.sum()) + 12 * n_ov + nbytes(nb, got)
                + 2 * c * int(torch.unique(xrows).numel())
                + 2 * co * int(torch.unique(grows).numel()),
                2.0 * n_ov * c * co,
            )
            results[dname].append(dict(
                shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                entries=n_ov, walked=int(nb.sum()),
            ))
        del gy_int, gy_real, nbr, hit4, flat_rows
        emit({"phase": "kernel", "shape": label, "window_r": r,
              "table_rows_per_event": [int(tab.n_active.min()),
                                       int(tab.n_active.max())],
              "pairs": pairs_total, "overflow_entries": n_ov, **occupancy,
              "rows": {n: v[-1] for n, v in results.items()
                       if v and v[-1]["shape"] == label}})
    return results


def _swap_dx_list(apply, is_dx_call):
    """The dX sidecar as it was once wrong: the twin list TRANSPOSED and the
    weights left unpermuted, instead of the list as it is with permuted
    weights.  ``is_dx_call(out, table, plan)`` picks the calls to break."""
    import dataclasses

    import torch

    from sparseeventid_tpu_torch.ops.window.engine import _mirror_perm
    from sparseeventid_tpu_torch.ops.window.kernels import _ov_bound

    def patched(out, table, w, plan):
        if is_dx_call(out, table, plan):
            perm = torch.as_tensor(_mirror_perm(plan.offsets), device=w.device)
            # transposed, then sorted by the new dst over the walked prefix,
            # as the sidecar kernel needs every list: the fault is the pair
            # set, not the order
            nb = _ov_bound(plan.ov_valid)
            pos = torch.arange(plan.ov_src.shape[1], device=w.device)
            key = torch.where(pos[None, :] < nb[:, None], plan.ov_src.long(),
                              2**40)
            order = torch.sort(key, dim=1, stable=True).indices
            take = lambda x: torch.gather(x, 1, order)  # noqa: E731
            plan = dataclasses.replace(
                plan, ov_src=take(plan.ov_dst), ov_dst=take(plan.ov_src),
                ov_k=take(plan.ov_k), ov_valid=take(plan.ov_valid))
            w = w[perm].contiguous()  # perm is an involution: undoes it
        return apply(out, table, w, plan)

    return patched


def _no_dw_sidecar(x, gy, src, dst, plan):
    """The dW sidecar left out."""
    import torch

    return torch.zeros((plan.num_offsets, x.shape[-1], gy.shape[-1]),
                       device=x.device)


def phase_grad_check(dataset) -> None:
    """dX and dW of the window autograd Functions against the plain rulebook
    backend's autograd, integer-valued fp32 data: exact equality, then two
    planted faults that the equality must catch."""
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import conv as C
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.ops.window import query as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    st = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                  capacity=caps[0], device=dev)
    tuning = Q.WindowTuning()
    c_in, c_out = 32, 48  # unequal, so the planted fault can tell dX's call

    def ints(shape, mask=None):
        x = _int_like(shape, gen, dev, torch.float32)
        return x if mask is None else x * mask[..., None]

    def grads(conv, x0, w0, gy):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        conv(st.with_feats(x), w).feats.backward(gy)
        torch.cuda.synchronize()
        return x.grad, w.grad

    x0 = ints((st.batch_size, st.capacity, c_in), st.row_mask())
    plan = E.build_series_plan(st, (3, 3, 3), backend=E.WINDOW,
                               window_r=tuning.for_level(0))
    book = rb.build_submanifold_rulebook(st, (3, 3, 3))
    sk, (fwd, rev), _ = E.build_downsample_plan(
        st, (2, 2, 2), caps[1], backend=E.WINDOW, tuning=tuning)
    dbook = rb.build_downsample_rulebook(st, sk, (2, 2, 2))
    # at the main path's reverse window nearly every parent is in-window;
    # a 64-row window puts tens of thousands of pairs on the reverse list
    _, (nfwd, nrev), _ = E.build_downsample_plan(
        st, (2, 2, 2), caps[1], backend=E.WINDOW,
        tuning=Q.WindowTuning(window_r=64))
    entries = {"series": int(plan.ov_valid.sum()),
               "down_fwd": int(fwd.ov_valid.sum()),
               "down_rev": int(rev.ov_valid.sum()),
               "down_rev_narrow": int(nrev.ov_valid.sum())}
    require(min(entries["series"], entries["down_fwd"],
                entries["down_rev_narrow"]) > 1000,
            f"overflow lists are too short to test the sidecars: {entries}")
    for p in (plan, fwd, rev, nfwd, nrev):
        require(int(p.ov_dropped.sum()) == 0, "an overflow list was clamped")
    cases = {
        "submanifold": (
            lambda s, w: WE.window_submanifold_conv(s, plan, w),
            lambda s, w: C.submanifold_conv(s, book, w),
            ints((27, c_in, c_out)),
            ints((st.batch_size, st.capacity, c_out), st.row_mask()),
        ),
        "strided": (
            lambda s, w: WE.window_strided_conv(s, sk, fwd, rev, w),
            lambda s, w: C.strided_conv(s, sk, dbook, w),
            ints((8, c_in, c_out)),
            ints((sk.batch_size, sk.capacity, c_out), sk.row_mask()),
        ),
    }
    cases["strided_narrow_reverse"] = (
        lambda s, w: WE.window_strided_conv(s, sk, nfwd, nrev, w),
        *cases["strided"][1:],
    )
    report = {"phase": "grad_check", "dtype": "float32", "entries": entries}
    want = {}
    for name, (win, ref, w0, gy) in cases.items():
        got = grads(win, x0, w0, gy)
        want[name] = grads(ref, x0, w0, gy)
        same = [torch.equal(g, r) for g, r in zip(got, want[name])]
        report[name] = {"dx_equal": same[0], "dw_equal": same[1],
                        "dx_abs_sum": float(got[0].abs().sum()),
                        "dw_abs_sum": float(got[1].abs().sum())}
        require(all(same), f"{name} conv gradients differ from the plain "
                f"backend's: dx, dw equal = {same}")
        require(report[name]["dw_abs_sum"] > 0, f"{name}: dw is all 0")

    # planted faults, on the submanifold case
    win, _, w0, gy = cases["submanifold"]
    faults = {
        "dw_sidecar_skipped": ("_overflow_dw", _no_dw_sidecar, 1),
        # c_in != c_out tells the dX call from the forward's
        "twin_list_transposed": ("_apply_overflow", _swap_dx_list(
            WE._apply_overflow,
            lambda out, table, p: out.shape[-1] == c_in != table.shape[-1]), 0),
    }
    for fault, (attr, patched, broken) in faults.items():
        sound = getattr(WE, attr)
        setattr(WE, attr, patched)
        try:
            got = grads(win, x0, w0, gy)
        finally:
            setattr(WE, attr, sound)
        same = [torch.equal(g, r) for g, r in zip(got, want["submanifold"])]
        report[fault] = {"dx_equal": same[0], "dw_equal": same[1],
                         "max_abs_diff": float(
                             (got[broken] - want["submanifold"][broken]).abs().max())}
        require(not same[broken],
                f"the exact gradient check is blind to the fault {fault}")
    emit(report)


def phase_gather_kernels(dataset):
    """Kernels 9 and 10 against their plain versions at dune3d shapes ->
    per-kernel rows.  window_gather: the deconv's shape (level-1 table,
    level-0 queries over the reverse plan, K = 8) and the level-0 series
    shape (K = 27, C = 32), bit-equal on real-valued bf16 data.
    gather_conv: levels 0 and 5 over the real rulebooks, bit-equal on
    integer-valued data.  The deconv's two-step dW is timed beside
    window_dw at the same shape."""
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    bf16 = torch.bfloat16
    st0 = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                   capacity=caps[0], device=dev)
    levels = [st0]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], (2, 2, 2), cap))
    tuning = Q.WindowTuning()

    def feats_of(st, c, integer=False):
        shape = (st.batch_size, st.capacity, c)
        x = (_int_like(shape, gen, dev, bf16) if integer
             else torch.randn(shape, generator=gen, device=dev).to(bf16))
        return torch.where(st.row_mask()[..., None], x, 0).contiguous()

    results = {n: [] for n in OPS_KERNELS}
    results["window_dw"] = []  # its deconv shape; the main shapes: kernel phase

    # ---- window_gather
    fwd, rev = E.build_upsample_plan(levels[1], st0, (2, 2, 2),
                                     backend=E.WINDOW, tuning=tuning)
    series = E.build_series_plan(st0, (3, 3, 3), backend=E.WINDOW,
                                 window_r=tuning.for_level(0))
    gather_cases = [
        ("deconv L1->L0 2^3 C=64", levels[1], st0, rev, 64),
        ("L0 series 3^3 C=32", st0, st0, series, 32),
    ]
    for label, tab, qst, plan, c in gather_cases:
        require(int(plan.ov_dropped.sum()) == 0, f"list clamped at {label}")
        keys = tab.keys()
        x = feats_of(tab, c)
        args = (keys, x, plan.qmeta, plan.start, plan.q_active, plan.dkeys)
        got = K.window_gather(*args, window_r=plan.window_r)
        want = K.window_gather_plain(*args, window_r=plan.window_r)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"window_gather differs from its plain version at {label}")
        k = plan.num_offsets
        matched = got.view(*got.shape[:2], k, c).ne(0).any(dim=-1)
        n_matched = int(matched.sum())
        require(n_matched > 0, f"window_gather matched nothing at {label}")
        del want
        ms = timed_ms(lambda: K.window_gather(*args, window_r=plan.window_r))
        plain_ms = timed_ms(
            lambda: K.window_gather_plain(*args, window_r=plan.window_r),
            iters=2, warmup=1, graph=False)
        # yardstick: one index gather of the matched rows, indices given
        rows = torch.zeros((qst.batch_size, qst.capacity, k), dtype=torch.int64,
                           device=dev)
        found = torch.zeros_like(rows, dtype=torch.bool)
        for kk, f, r in K._matched_rows(keys, plan.qmeta, plan.start,
                                        plan.q_active, plan.dkeys, None,
                                        plan.window_r, None):
            rows[:, :, kk], found[:, :, kk] = r, f
        flat = rows.reshape(qst.batch_size, -1, 1)
        mask = found.reshape(qst.batch_size, -1, 1)

        def library():
            g = torch.gather(x, 1, flat.expand(-1, -1, c))
            return torch.where(mask, g, 0)

        require(torch.equal(library().reshape(got.shape), got),
                f"the library gather differs at {label}")
        lib_ms = timed_ms(library)
        n_q = int(qst.n_active.sum())
        live_tiles = int(((qst.n_active + Q.TILE_T - 1) // Q.TILE_T).sum())
        distinct = int(torch.unique(
            rows[found] + (torch.nonzero(found)[:, 0] * tab.capacity)).numel())
        # reads: keys of the active table rows, each distinct matched row
        # once, the live queries' meta, the live tiles' starts; writes: the
        # output in full (unmatched slots and dead rows are defined as 0)
        b_ms, b_by = bound(
            4 * int(tab.n_active.sum()) + 2 * c * distinct
            + 4 * plan.qmeta.shape[1] * n_q + 4 * k * live_tiles
            + nbytes(plan.q_active, got), 0)
        results["window_gather"].append(dict(
            shape=label, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            matched_slots=n_matched, output_mb=nbytes(got) / 1e6,
        ))
        row = {"window_gather": results["window_gather"][-1]}
        if plan is rev:
            # the deconv's dW both ways: gather + one float32 product (the
            # port's route), and window_dw at the same shape
            gy = feats_of(qst, 32)

            def two_step():
                g1 = K.window_gather(*args, window_r=plan.window_r)
                return torch.einsum("bno,bnm->mo", gy.float(), g1.float())

            def fused():
                return K.window_dw(keys, x, plan.qmeta, plan.start, gy,
                                   plan.q_active, plan.dkeys,
                                   window_r=plan.window_r)

            a, b = two_step().reshape(k, c, 32), fused()
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            # float32 sums of up to 4e5 bf16 products in two orders
            require(err <= 1e-3 * scale,
                    f"two-step dW differs from window_dw: {err} of {scale}")
            row["deconv_dw"] = dict(
                two_step_ms=timed_ms(two_step), window_dw_ms=timed_ms(fused),
                max_abs_diff=err, max_abs=scale)
            # window_dw's own row at this shape: bit-equal to its plain
            # version on integer data, then timed as in the kernel phase
            x_int, gy_int = feats_of(tab, c, integer=True), feats_of(qst, 32, True)
            for dt in (bf16, torch.float32):
                dargs = (keys, x_int.to(dt), plan.qmeta, plan.start,
                         gy_int.to(dt), plan.q_active, plan.dkeys)
                got_dw = K.window_dw(*dargs, window_r=plan.window_r)
                want_dw = K.window_dw_plain(*dargs, window_r=plan.window_r)
                torch.cuda.synchronize()
                require(torch.equal(got_dw, want_dw) and float(got_dw.abs().sum()) > 0,
                        f"window_dw differs from its plain version, {dt}, at {label}")

            def plain_dw():
                return K.window_dw_plain(keys, x, plan.qmeta, plan.start, gy,
                                         plan.q_active, plan.dkeys,
                                         window_r=plan.window_r)

            book = rb.build_upsample(tab, qst, (2, 2, 2))
            nbr_up = book.neighbor_idx.long().reshape(qst.batch_size, -1, 1)
            hit_up = book.hit[..., None]

            def library_dw():
                xg = torch.gather(x, 1, nbr_up.expand(-1, -1, c))
                xg = xg.reshape(*book.hit.shape, c) * hit_up
                return torch.einsum("bmkc,bmo->kco", xg, gy)

            pairs_in = int(found.sum())
            b_ms, b_by = bound(
                (4 + 2 * c) * int(tab.n_active.sum())
                + (4 * plan.qmeta.shape[1] + 2 * 32) * n_q + 4 * k * live_tiles
                + nbytes(plan.q_active, b), 2.0 * pairs_in * c * 32)
            results["window_dw"].append(dict(
                shape=f"deconv L1->L0 2^3 {c}->32", max_abs_err=float(
                    (fused() - plain_dw()).abs().max()),
                ms=timed_ms(fused),
                plain_ms=timed_ms(plain_dw, iters=2, warmup=1, graph=False),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timed_ms(library_dw, iters=3, warmup=1),
                pairs_in_window=pairs_in, live_tiles=live_tiles,
                blocks=K._dw_parts(dev, qst.batch_size, qst.capacity, k, c, 32)))
            row["window_dw"] = results["window_dw"][-1]
            del book, nbr_up, hit_up, x_int, gy_int
        emit({"phase": "gather_kernel", "shape": label,
              "window_r": plan.window_r, "rows": row})
        del got, rows, found, flat, mask, x
        torch.cuda.empty_cache()

    # ---- gather_conv over the full rulebooks
    for label, st, c, co in (("L0 series 3^3 32->32", st0, 32, 32),
                             ("L5 series 3^3 192->192", levels[5], 192, 192)):
        book = rb.build_submanifold_rulebook(st, (3, 3, 3))
        idx = GC._encode_miss(book, st.capacity)
        pairs = int(book.hit.sum())
        w_int = _int_like((27, c, co), gen, dev, bf16)
        x_int = feats_of(st, c, integer=True)
        got = GC.gather_conv(x_int, idx, w_int)
        want = GC.gather_conv_plain(x_int, idx, w_int)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"gather_conv differs from its plain version at {label}")
        require(float(got.float().abs().sum()) > 0, f"all 0 at {label}")
        x = feats_of(st, c)
        w = (torch.randn((27, c, co), generator=gen, device=dev)
             / (27 * c) ** 0.5).to(bf16).contiguous()
        err = (GC.gather_conv(x, idx, w).float()
               - GC.gather_conv_plain(x, idx, w).float()).abs().max().item()
        ms = timed_ms(lambda: GC.gather_conv(x, idx, w))
        plain_ms = timed_ms(lambda: GC.gather_conv_plain(x, idx, w),
                            iters=2, warmup=1, graph=False)
        flat = book.neighbor_idx.long().reshape(st.batch_size, -1, 1)
        hit = book.hit.reshape(st.batch_size, -1, 1)
        w2 = w.reshape(27 * c, co)

        def library():
            g = torch.gather(x, 1, flat.expand(-1, -1, c)) * hit
            return torch.matmul(g.reshape(st.batch_size, st.capacity, 27 * c), w2)

        lib_ms = timed_ms(library)
        n_live = int(st.n_active.sum())
        # reads: the features of the active rows, the live rows' indices,
        # W; writes: the output in full; flops: the hit pairs only
        b_ms, b_by = bound(
            2 * c * n_live + 4 * 27 * n_live + nbytes(w, got),
            2.0 * pairs * c * co)
        results["gather_conv"].append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, pairs=pairs,
        ))
        emit({"phase": "gather_kernel", "shape": label,
              "rows": {"gather_conv": results["gather_conv"][-1]}})
        del got, want, x, x_int, flat, hit, idx, book
        torch.cuda.empty_cache()
    return results


def phase_engine_ops(dataset):
    """The engine's remaining ops on integer-valued fp32 data on the card,
    each against the plain backend under autograd, exactly; two planted
    faults that the equality must catch; then the two ops no model selects
    driven at full width in bf16 through the entry points a user calls
    (ConvolutionUpsample, gather_submanifold_conv) -> their launch counts."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.config.schema import ConvRepresentation, Norm
    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models import blocks as B
    from sparseeventid_tpu_torch.models import init_parameters
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import conv as C
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    fine = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                    capacity=caps[0], device=dev)
    coarse = rb.downsample_sites(fine, (2, 2, 2), caps[1])
    c_in, c_out = 32, 48

    def ints(shape, mask=None):
        x = _int_like(shape, gen, dev, torch.float32)
        return x if mask is None else x * mask[..., None]

    def grads(fn, st, x0, w0, gy):
        """(out, dx, dw) of fn(st with x0, w0) under the cotangent gy."""
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = fn(st.with_feats(x), w).feats
        out.backward(gy)
        torch.cuda.synchronize()
        return out.detach(), x.grad, w.grad

    def compare(got, want):
        return [bool(torch.equal(g, r)) for g, r in zip(got, want)]

    report = {"phase": "engine_ops", "dtype": "float32"}

    # ---- the deconv: coarse level 1 -> fine level 0
    xc = ints((coarse.batch_size, coarse.capacity, c_in), coarse.row_mask())
    gy_f = ints((fine.batch_size, fine.capacity, c_out), fine.row_mask())
    w8 = ints((8, c_in, c_out))
    book = rb.build_upsample(coarse, fine, (2, 2, 2))
    want = grads(lambda s, w: C.deconv(s, fine, book, w), coarse, xc, w8, gy_f)
    require(float(want[2].abs().sum()) > 0, "the plain deconv's dw is all 0")
    plans = {
        "deconv": E.build_upsample_plan(coarse, fine, (2, 2, 2),
                                        backend=E.WINDOW),
        # a 64-row reverse window fills the reverse list
        "deconv_narrow_reverse": E.build_upsample_plan(
            coarse, fine, (2, 2, 2), backend=E.WINDOW,
            tuning=Q.WindowTuning(window_r=64)),
    }
    for name, (fwd, rev) in plans.items():
        require(int(fwd.ov_dropped.sum() + rev.ov_dropped.sum()) == 0,
                f"{name}: an overflow list was clamped")
        got = grads(lambda s, w: E.apply_upsample(s, fine, (fwd, rev), w),
                    coarse, xc, w8, gy_f)
        same = compare(got, want)
        report[name] = {"out_dx_dw_equal": same,
                        "forward_entries": int(fwd.ov_valid.sum()),
                        "reverse_entries": int(rev.ov_valid.sum())}
        require(all(same), f"{name}: out, dx, dw equal the plain deconv's = {same}")
    narrow = plans["deconv_narrow_reverse"]
    require(int(narrow[1].ov_valid.sum()) > 1000,
            f"the narrow reverse list is too short: {report}")
    sound = WE._overflow_dw
    WE._overflow_dw = _no_dw_sidecar
    try:
        got = grads(lambda s, w: E.apply_upsample(s, fine, narrow, w),
                    coarse, xc, w8, gy_f)
    finally:
        WE._overflow_dw = sound
    same = compare(got, want)
    report["deconv_dw_sidecar_skipped"] = {
        "out_dx_dw_equal": same,
        "max_abs_diff": float((got[2] - want[2]).abs().max())}
    require(same[0] and same[1] and not same[2],
            "the exact deconv check is blind to a skipped dW sidecar")

    # ---- pooling downsample: the window branch against the plain branch
    # (no norm and a slope of 1, so every sum stays exact)
    params = ConvRepresentation(normalization=Norm.none, leakiness=1.0)
    xf = ints((fine.batch_size, fine.capacity, c_in), fine.row_mask())
    gy_c = ints((coarse.batch_size, coarse.capacity, c_out), coarse.row_mask())
    w_pool, b_pool = ints((1, c_in, c_out)), ints((c_out,))
    pooled = {}
    for backend in (E.WINDOW, E.XLA):
        mod = B.PoolingDownsample(c_in, c_out, (2, 2, 2), params,
                                  out_capacity=caps[1], backend=backend).to(dev)
        with torch.no_grad():
            mod.w.copy_(w_pool)
            mod.b.copy_(b_pool)
        x = xf.clone().requires_grad_(True)
        out, dropped = mod(fine.with_feats(x))
        require(int(dropped) == 0, f"pooling {backend}: dropped {int(dropped)}")
        out.feats.backward(gy_c)
        torch.cuda.synchronize()
        pooled[backend] = (out.feats.detach(), x.grad, mod.w.grad, mod.b.grad)
    same = compare(pooled[E.WINDOW], pooled[E.XLA])
    report["pooling_downsample"] = {"out_dx_dw_db_equal": same}
    require(all(same) and float(pooled[E.XLA][2].abs().sum()) > 0,
            f"pooling: window branch vs plain branch equal = {same}")
    del pooled

    # ---- the gather conv against the plain conv's autograd, level 0
    sbook = rb.build_submanifold_rulebook(fine, (3, 3, 3))
    w27 = ints((27, c_in, c_out))
    want = grads(lambda s, w: C.submanifold_conv(s, sbook, w), fine, xf, w27,
                 gy_f)
    got = grads(lambda s, w: GC.gather_submanifold_conv(s, sbook, w), fine, xf,
                w27, gy_f)
    same = compare(got, want)
    report["gather_conv"] = {"out_dx_dw_equal": same}
    require(all(same), f"gather conv vs plain conv equal = {same}")
    mirror = GC.mirror_permutation
    GC.mirror_permutation = lambda offsets: np.arange(len(offsets))
    try:
        got = grads(lambda s, w: GC.gather_submanifold_conv(s, sbook, w), fine,
                    xf, w27, gy_f)
    finally:
        GC.mirror_permutation = mirror
    same = compare(got, want)
    report["gather_conv_dx_both_permuted"] = {
        "out_dx_dw_equal": same,
        "max_abs_diff": float((got[1] - want[1]).abs().max())}
    require(same[0] and same[2] and not same[1],
            "the exact gather conv check is blind to dX with both permuted")
    emit(report)
    del want, got, xf, gy_f, gy_c, xc
    torch.cuda.empty_cache()

    # ---- ops_path: full width, bf16, forward and backward, counted
    bf16 = torch.bfloat16
    wrappers, plains = _kernel_counters()
    counted = wrappers + [K.window_gather, GC.gather_conv]
    plains = plains + [K.window_gather_plain, GC.gather_conv_plain]
    for f in counted:
        f.launches = 0
    for f in plains:
        f.calls = 0
    up = B.ConvolutionUpsample(64, 32, (2, 2, 2), ConvRepresentation(),
                               backend=E.WINDOW)
    init_parameters(up, SEED).to(dev).train()
    xc = torch.where(
        coarse.row_mask()[..., None],
        torch.randn((coarse.batch_size, coarse.capacity, 64), generator=gen,
                    device=dev), 0).to(bf16).requires_grad_(True)
    t0 = time.perf_counter()
    out, dropped = up(coarse.with_feats(xc), fine)
    out.feats.float().square().mean().backward()
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    require(int(dropped) == 0, f"upsample block dropped {int(dropped)}")
    require(out.feats.shape == (fine.batch_size, fine.capacity, 32)
            and out.feats.dtype == bf16, "upsample block output shape")
    for name, t in (("out", out.feats), ("dx", xc.grad), ("dw", up.w.grad)):
        t = t.detach().float()
        require(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0,
                f"upsample block {name} not finite or all 0")
    w = torch.nn.Parameter(
        torch.randn((27, 32, 32), generator=gen, device=dev) / (27 * 32) ** 0.5)
    xf = torch.where(
        fine.row_mask()[..., None],
        torch.randn((fine.batch_size, fine.capacity, 32), generator=gen,
                    device=dev), 0).to(bf16).requires_grad_(True)
    t0 = time.perf_counter()
    gout = GC.gather_submanifold_conv(fine.with_feats(xf), sbook, w)
    gout.feats.float().square().mean().backward()
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    ref = C.submanifold_conv(fine.with_feats(xf.detach()), sbook, w.detach())
    err = float((gout.feats.detach().float() - ref.feats.float()).abs().max())
    # one bf16 rounding of sums of about 27 x 32 products of unit scale
    require(err <= 0.05, f"gather conv differs from the plain conv by {err}")
    for name, t in (("out", gout.feats), ("dx", xf.grad), ("dw", w.grad)):
        t = t.detach().float()
        require(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0,
                f"gather conv {name} not finite or all 0")
    launches = {f.__name__: f.launches for f in counted}
    plain_calls = {f.__name__: f.calls for f in plains}
    require(launches == OPS_PATH_LAUNCHES,
            f"ops_path launch counts {launches} differ from the expected "
            f"{OPS_PATH_LAUNCHES}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the ops path: {plain_calls}")
    emit({"phase": "ops_path", "precision": "bfloat16", "launches": launches,
          "plain_calls": plain_calls, "upsample_block_s": up_s,
          "gather_conv_s": gather_s, "gather_conv_max_abs_diff": err})
    return launches


def train_config(extra=(), recipe="dune3d"):
    from sparseeventid_tpu_torch.config import load_config

    return load_config(recipe, [
        "mode=train", f"run.minibatch_size={BATCH}", f"run.seed={SEED}",
        "framework.sparse_backend=window", "data.mode=serial_access",
        *extra,
    ])


def _kernel_counters():
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import sidecar as S

    wrappers = [K.window_plan, K.window_conv_apply, K.overflow_apply,
                S.overflow_apply_batched, K.window_bwd_strided, K.window_dw,
                S.overflow_dw_batched, K.overflow_dw]
    plains = [K.window_plan_plain, K.window_conv_apply_plain,
              K.overflow_apply_plain, K.window_bwd_strided_plain,
              K.window_dw_plain, K.overflow_dw_plain]
    return wrappers, plains


def phase_train(dataset, recipe="dune3d", grid=GRID, phase="train"):
    """The train step at full width through the trainer's loop -> the
    launch counts of the run."""
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.train.trainer import train

    cfg = train_config(["run.precision=bfloat16",
                        f"mode.iterations={TRAIN_STEPS}"], recipe)
    require(cfg.head.dropout > 0, "the train phase runs with dropout on")
    wrappers, plains = _kernel_counters()
    for f in wrappers:
        f.launches = 0
    for f in plains:
        f.calls = 0
    torch.cuda.reset_peak_memory_stats()
    run = train(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in wrappers}
    plain_calls = {f.__name__: f.calls for f in plains}
    history, state = run.history, run.state
    require(len(history) == TRAIN_STEPS == state.step, "steps taken")
    for i, m in enumerate(history):
        require(np.isfinite(m["loss/loss"]), f"step {i}: loss not finite: {m}")
        require(m["overflow/dropped"] == 0, f"step {i}: dropped pairs: {m}")
    expected = {k: v * TRAIN_STEPS for k, v in LAUNCHES_PER_TRAIN_STEP.items()}
    require(launches == expected,
            f"launch counts {launches} differ from the expected {expected}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the train path: {plain_calls}")
    # every update moved Adam's moments by that step's gradient: a moment
    # that is finite shows finite gradients, one that is 0 everywhere a
    # gradient that was 0 at every step
    conv_weights, zero_grad, not_finite = 0, [], []
    for name, p in state.model.named_parameters():
        moments = state.optimizer.state[p]
        if not (torch.isfinite(moments["exp_avg"]).all()
                and torch.isfinite(moments["exp_avg_sq"]).all()
                and torch.isfinite(p).all()):
            not_finite.append(name)
        if p.dim() == 3:
            conv_weights += 1
            if float(moments["exp_avg_sq"].max()) == 0.0:
                zero_grad.append(name)
    require(not not_finite, f"gradient or parameter not finite: {not_finite}")
    require(conv_weights == 55 and not zero_grad,
            f"{conv_weights} conv weights, gradient 0 on {zero_grad}")
    stats = [(n, b) for n, b in state.model.named_buffers()]
    still = [n for n, b in stats
             if torch.equal(b, torch.zeros_like(b) if n.endswith("mean")
                            else torch.ones_like(b))]
    require(stats and not still, f"running statistics did not move: {still}")
    timed = [m["time/step_s"] for m in history[1:]]
    steps_per_s = len(timed) / sum(timed)
    emit({"phase": phase, "recipe": recipe, "steps": TRAIN_STEPS, "step_s": [m["time/step_s"]
                                                            for m in history],
          "loss": [m["loss/loss"] for m in history],
          "lr": [m["opt/lr"] for m in history],
          "launches": launches, "launches_per_step": LAUNCHES_PER_TRAIN_STEP,
          "plain_calls": plain_calls, "conv_weights": conv_weights,
          "running_stats": len(stats),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(json.dumps({f"{phase}_steps_per_s": steps_per_s,
                      f"{phase}_events_per_s": steps_per_s * BATCH,
                      "timed_steps": len(timed), "batch": BATCH,
                      "precision": "bfloat16"}), flush=True)
    profile_train_step(dataset, recipe, grid, phase)
    return launches


def _device_profile(fn):
    """Run ``fn`` under torch.profiler -> (wall ms, device-busy ms, the 15
    kernels with the most device time, and the device time and launches of
    each kernel of csrc/ by function name, bf16 and fp32 instances merged)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    port = {}
    for e in kernels:  # the port's kernels live in anonymous namespaces
        found = re.search(r"\(anonymous namespace\)::(\w+)", e.key)
        if found:
            row = port.setdefault(found.group(1), {"ms": 0.0, "count": 0})
            row["ms"] += e.self_device_time_total / 1e3
            row["count"] += e.count
    return wall_ms, busy_ms, [
        {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
         "count": e.count} for e in top], port


def profile_train_step(dataset, recipe="dune3d", grid=GRID,
                       phase="train") -> None:
    """Device time by kernel over one bf16 train step (input preparation
    included, as in the loop), and the share of the wall time the device
    was busy.  The step before it warms the new model up."""
    import torch

    from sparseeventid_tpu_torch.train.evaluate import feature_dtype, prepare_batch
    from sparseeventid_tpu_torch.train.trainer import build_training

    cfg = train_config(["run.precision=bfloat16"], recipe)
    dev = torch.device(DEVICE)
    state, step, _ = build_training(cfg, N_BATCHES, None, dev)
    generator = torch.Generator(device=dev).manual_seed(SEED + 1)
    cap0 = state.model.encoder.capacities[0]

    def one_step(first):
        st, labels = prepare_batch(dataset.batch([first]), grid, cap0,
                                   feature_dtype(cfg), dev)
        return float(step(st, labels, generator)["loss/loss"])

    one_step(0)
    wall_ms, busy_ms, top, port = _device_profile(lambda: one_step(BATCH))
    emit({"phase": f"profile_{phase}", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "top_kernels": top, "port_kernels": port})


def profile_one_batch(cfg, dataset, grid=GRID, phase="profile") -> None:
    """Device time by kernel over one bf16 batch through validate(), and
    the share of the wall time the device was busy."""
    from sparseeventid_tpu_torch.train.evaluate import validate

    one = CachedDataset(grid, {0: dataset.batch([0])}, BATCH)
    wall_ms, busy_ms, top, port = _device_profile(
        lambda: validate(cfg, dataset=one, device=DEVICE))
    emit({"phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms, "top_kernels": top,
          "port_kernels": port})


def phase_main(dataset, out_dir: Path, recipe="dune3d", grid=GRID,
               phase="main"):
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.train.evaluate import validate

    out_file = out_dir / f"chip_smoke_softmax_{recipe}.npz"
    cfg = load_config(recipe, [
        "mode=inference", "run.precision=bfloat16",
        f"run.minibatch_size={BATCH}", "framework.sparse_backend=window",
        f"run.seed={SEED}", f"mode.output_file={out_file}",
    ])
    wrappers, plains = _kernel_counters()
    # warm-up on the first batch (allocator, cuBLAS handles), then the run
    warm = CachedDataset(grid, {0: dataset.batch([0])}, BATCH)
    validate(cfg, dataset=warm, device=DEVICE)
    for f in wrappers:
        f.launches = 0
    for f in plains:
        f.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = validate(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in wrappers}
    plain_calls = {f.__name__: f.calls for f in plains}
    require(np.isfinite(metrics["loss/loss"]), f"loss not finite: {metrics}")
    require(metrics["overflow/dropped"] == 0, f"dropped pairs: {metrics}")
    # inference launches every forward kernel and no backward one
    require(all((v > 0) == (k in FORWARD_KERNELS) for k, v in launches.items()),
            f"launch counts of the inference path: {launches}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the main path: {plain_calls}")
    soft = np.load(out_file)
    for k, n in OUTPUT_SHAPE.items():
        require(soft[k].shape == (BATCH * N_BATCHES, n), f"softmax {k} shape")
        require(np.all(np.isfinite(soft[k])), f"softmax {k} not finite")
    events = BATCH * N_BATCHES
    print(json.dumps({f"{phase}_events_per_s": events / seconds,
                      "events": events, "batch": BATCH,
                      "precision": "bfloat16"}), flush=True)
    emit({"phase": phase, "recipe": recipe, "events": events, "seconds": seconds,
          "events_per_s": events / seconds, "metrics": metrics,
          "launches": launches, "launches_per_forward":
          {k: v / N_BATCHES for k, v in launches.items() if v},
          "plain_calls": plain_calls,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    profile_one_batch(cfg, dataset, grid,
                      "profile" if phase == "main" else f"profile_{phase}")
    return launches


# fp32 agreement of the window kernels with the plain rulebook backend.
# At random init the eval-mode norms are identities and the final series'
# features reach ~1e3, so their check scales atol with the reference's
# magnitude; the logits (a pool over the grid volume, then the heads) are
# ~1e-2 and keep the absolute atol.  Planted faults show where the limits
# sit: a fault must fail the feature check.
FP32_RTOL = 1e-3
FP32_ATOL_LOGITS = 1e-3
FP32_ATOL_FEATS_PER_SCALE = 1e-3


def phase_fp32(dataset) -> None:
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.ops.window import engine as WE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    image = dataset.batch([0])["image"]

    def model_of(backend):
        c32 = load_config("dune3d", [
            "mode=inference", "run.precision=float32",
            f"framework.sparse_backend={backend}",
        ])
        return init_parameters(build_sparse_classifier(c32), SEED).to(DEVICE).eval()

    def forward(model, what):
        st = larcv_batch_to_sparse_3d(image, GRID,
                                      capacity=model.encoder.capacities[0],
                                      device=DEVICE)
        got = {}
        hook = model.encoder.final_series.register_forward_hook(
            lambda mod, inp, out: got.__setitem__("feats", out.feats.cpu())
        )
        with torch.no_grad():
            lg, dropped = model(st)
        hook.remove()
        require(int(dropped) == 0, f"{what}: dropped {int(dropped)}")
        return got["feats"], torch.cat([lg[k] for k in OUTPUT_SHAPE], dim=1).cpu()

    ref_feats, ref_logits = forward(model_of("xla"), "xla")
    scale = ref_feats.abs().max().item()
    limits = {"final_series_feats": FP32_ATOL_FEATS_PER_SCALE * scale,
              "logits": FP32_ATOL_LOGITS}

    def compare(feats, logits):
        row = {}
        for what, a, b in (("final_series_feats", feats, ref_feats),
                           ("logits", logits, ref_logits)):
            row[what] = {"max_abs_diff": (a - b).abs().max().item(),
                         "max_abs": b.abs().max().item(),
                         "atol": limits[what],
                         "within": torch.allclose(a, b, rtol=FP32_RTOL,
                                                  atol=limits[what])}
        return row

    window = model_of("window")
    report = {"phase": "fp32_compare", "rtol": FP32_RTOL,
              "sound": compare(*forward(window, "window"))}
    for what, row in report["sound"].items():
        require(row["within"], f"fp32 {what} differ: {row}")

    # planted faults: out-of-window pairs lost, or counted twice (what a
    # conv that ignored its window would do)
    apply = WE._apply_overflow
    faults = {
        "sidecar_skipped": lambda out, table, w, plan: out,
        "sidecar_twice": lambda out, table, w, plan: apply(
            apply(out, table, w, plan), table, w, plan),
    }
    for fault, patched in faults.items():
        WE._apply_overflow = patched
        try:
            report[fault] = compare(*forward(window, fault))
        finally:
            WE._apply_overflow = apply
        require(not report[fault]["final_series_feats"]["within"],
                f"fp32 check blind to the planted fault {fault}: {report[fault]}")
    emit(report)


# fp32 agreement of one train step's parameter gradients, window kernels
# against the plain rulebook backend: per tensor, the L2 norm of the
# difference over the L2 norm of the reference gradient, and the worst
# tensor decides.  The conv biases ahead of a batch norm are left out: their
# true gradient is 0 and both backends return rounding noise (1e-11 of the
# largest gradient).  At random init the backward passes 53 batch norms in
# train mode, each a cancellation, so float32 summation order alone moves a
# tensor's gradient by several 1e-3 of its norm (the plain backend does not
# repeat its own gradients bit for bit either: its gather's backward adds
# atomically); the planted faults move it by 0.2 and more.
FP32_GRAD_LIMIT = 0.04


def phase_fp32_grad(dataset) -> None:
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
    from sparseeventid_tpu_torch.ops.window import engine as WE
    from sparseeventid_tpu_torch.train.evaluate import prepare_batch
    from sparseeventid_tpu_torch.train.losses import multi_head_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    batch = {k: v[:FP32_GRAD_EVENTS] for k, v in dataset.batch([0]).items()}

    def model_of(backend):
        cfg = train_config(["run.precision=float32", "head.dropout=0.0",
                            f"framework.sparse_backend={backend}"])
        model = init_parameters(build_sparse_classifier(cfg), SEED)
        return cfg, model.to(dev).train()

    in_backward = {"on": False}  # read by the twin-list fault below

    def gradients(cfg, model, what):
        model.zero_grad(set_to_none=True)
        st, labels = prepare_batch(batch, GRID, model.encoder.capacities[0],
                                   torch.float32, dev)
        logits, dropped = model(st)
        scheme = cfg.mode.optimizer.loss_balance_scheme
        loss, _ = multi_head_loss(logits, labels, scheme)
        in_backward["on"] = True
        try:
            loss.backward()
        finally:
            in_backward["on"] = False
        torch.cuda.synchronize()
        require(int(dropped) == 0, f"{what}: dropped {int(dropped)}")
        loss = float(loss.detach())
        require(np.isfinite(loss), f"{what}: loss {loss}")
        return loss, {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    cfg_x, model_x = model_of("xla")
    ref_loss, ref = gradients(cfg_x, model_x, "xla")
    del model_x
    torch.cuda.empty_cache()
    compared = [n for n in ref if not n.endswith(".b")]
    require(all(float(ref[n].norm()) > 0 for n in compared),
            "a reference gradient is all 0")

    def compare(loss, grads):
        worst, worst_name, worst_max = 0.0, "", 0.0
        for name, g in grads.items():
            if name.endswith(".b"):  # a conv bias ahead of a batch norm
                continue
            diff = g - ref[name]
            rel = float(diff.norm()) / float(ref[name].norm())
            if rel > worst:
                worst, worst_name = rel, name
            worst_max = max(worst_max, float(diff.abs().max())
                            / float(ref[name].abs().max()))
        return {"loss": loss, "worst_rel_l2": worst, "worst_tensor": worst_name,
                "worst_rel_max_abs": worst_max,
                "within": worst <= FP32_GRAD_LIMIT}

    cfg_w, model_w = model_of("window")
    report = {"phase": "fp32_grad_compare", "events": FP32_GRAD_EVENTS,
              "limit": FP32_GRAD_LIMIT, "tensors": len(compared),
              "tensors_left_out": len(ref) - len(compared), "ref_loss": ref_loss,
              "sound": compare(*gradients(cfg_w, model_w, "window"))}

    # the twin-list fault breaks the dX sidecar of the series convs only in
    # the backward: the forward's calls of the same function stay sound
    faults = {
        "dw_sidecar_skipped": ("_overflow_dw", _no_dw_sidecar),
        "twin_list_transposed": ("_apply_overflow", _swap_dx_list(
            WE._apply_overflow,
            lambda out, table, p: in_backward["on"] and len(p.offsets) == 27)),
    }

    def run_fault(fault):
        attr, patched = faults[fault]
        sound = getattr(WE, attr)
        setattr(WE, attr, patched)
        try:
            return gradients(cfg_w, model_w, fault)
        finally:
            setattr(WE, attr, sound)

    for fault in faults:
        report[fault] = compare(*run_fault(fault))
    emit(report)
    require(report["sound"]["within"], f"fp32 gradients differ: {report['sound']}")
    for fault in faults:
        require(not report[fault]["within"],
                f"fp32 gradient check blind to the planted fault {fault}: "
                f"{report[fault]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "sparseeventid_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    out_dir = HERE / "output" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        name, _ = phase_device()
        phase_build()
        dataset = make_dataset()
        rows = phase_kernels(dataset)
        phase_grad_check(dataset)
        launches = phase_main(dataset, out_dir)
        train_launches = phase_train(dataset)
        phase_fp32(dataset)
        phase_fp32_grad(dataset)
        for kname, per_shape in phase_gather_kernels(dataset).items():
            rows.setdefault(kname, []).extend(per_shape)
        ops_launches = phase_engine_ops(dataset)
        del dataset
        dataset_2d = make_dataset_2d()
        rows_2d = phase_kernels(dataset_2d, GEOMETRY_2D)
        launches_2d = phase_main(dataset_2d, out_dir, "dune2d", GRID_2D,
                                 "main2d")
        train_launches_2d = phase_train(dataset_2d, "dune2d", GRID_2D,
                                        "train2d")
        kernels = []
        for kname, per_shape in rows.items():
            require(per_shape, f"no measurement of {kname}")
            if kname in OPS_KERNELS:
                head = per_shape[0]
                kernels.append(dict(
                    name=kname, route="cuda", source=SOURCES[kname],
                    replaces=REPLACES[kname], launches=ops_launches[kname],
                    path="ops_path (ConvolutionUpsample backward; "
                    "gather_submanifold_conv forward and backward)",
                    max_abs_err=max(r["max_abs_err"] for r in per_shape),
                    ms=head["ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    library_ms=head["library_ms"], shape=head["shape"],
                    shapes=per_shape,
                ))
                continue
            per_shape = per_shape + rows_2d[kname]
            # headline: the busiest conv level (level 0) where measured
            head = next(
                (r for r in per_shape if r["shape"].startswith("L0 series")),
                per_shape[0],
            )
            kernels.append(dict(
                name=kname, route="cuda", source=SOURCES[kname],
                replaces=REPLACES[kname],
                # the count of the path that is the kernel's own: the
                # inference run for the forward kernels, the train run for
                # the backward ones
                launches=(launches[kname] if kname in FORWARD_KERNELS
                          else train_launches[kname]),
                path=("main, train, main2d, train2d"
                      if kname in FORWARD_KERNELS else "train, train2d"),
                launches_train=train_launches[kname],
                launches_main2d=launches_2d[kname],
                launches_train2d=train_launches_2d[kname],
                launches_ops_path=ops_launches[kname],
                max_abs_err=max(r["max_abs_err"] for r in per_shape),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shape=head["shape"],
                shapes=per_shape,
            ))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
