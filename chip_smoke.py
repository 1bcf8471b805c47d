#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sparseeventid_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. device   the card's name, count, and nvidia-smi's name and power limit
  2. build    every CUDA kernel of csrc/ built with nvcc (sm_90a), in parallel
  3. kernel   each kernel against its plain PyTorch version on the card, at
              the main path's shapes from one synthetic dune3d batch:
              bit-equal on integer-valued bf16 data, max abs error on
              real-valued data, and times (kernel, plain version, a one-call
              PyTorch yardstick) beside the card's least time for the work
  4. main     full-width dune3d inference (B=8, 50k-voxel cap, depth 5,
              filters 32->192, bf16) through train.evaluate.validate:
              finite loss and softmax, no dropped pairs, every kernel
              launched and no plain version called; a profiled batch
  5. fp32     one batch at fp32, window kernels against the plain rulebook
              backend on the card, and the same check on two planted
              faults of the overflow sidecar, which it must catch
  6. the {"kernels": [...]} line, then {"ok": true, "device": {...}} last.

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
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

REPLACES = {
    "window_plan": "sparseeventid_tpu/ops/pallas/window_conv.py:607",
    "window_conv_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:993",
    "overflow_apply_batched": "sparseeventid_tpu/ops/pallas/window_sidecar.py:266",
    "overflow_apply": "sparseeventid_tpu/ops/pallas/window_conv.py:1783",
}
SOURCES = {
    "window_plan": "sparseeventid_tpu_torch/csrc/window_plan.cu",
    "window_conv_apply": "sparseeventid_tpu_torch/csrc/window_conv.cu",
    "overflow_apply_batched": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
    "overflow_apply": "sparseeventid_tpu_torch/csrc/overflow_apply.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise Failure(what)


def timed_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
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

    def __init__(self, image_size, batches: dict, n_events: int):
        self._image_size = tuple(image_size)
        self._batches = batches
        self.n = n_events

    def __len__(self):
        return self.n

    def image_size(self):
        return self._image_size

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


def _int_like(shape, gen, device, dtype, lo=-2, hi=3):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device=device).to(dtype)


def phase_kernels(dataset):
    """Kernel against plain version at main-path shapes -> per-kernel rows."""
    import torch

    from sparseeventid_tpu_torch.io import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q
    from sparseeventid_tpu_torch.ops.window.sidecar import overflow_apply_batched

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    caps = capacity_schedule(MAX_VOXELS, 5, 0.5, 1024)
    bf16 = torch.bfloat16
    st0 = larcv_batch_to_sparse_3d(dataset.batch([0])["image"], GRID,
                                   capacity=caps[0], device=dev)
    # site sets of every level (the downsample chain)
    levels = [st0]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], (2, 2, 2), cap))
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

    cases = []  # (label, table st, ksz, strided, window_r, C, CO)
    cases.append(("initial 5^3 1->32", st0, (5, 5, 5), False,
                  tuning.window_r_initial, 1, 32))
    cases.append(("L0 series 3^3 32->32", st0, (3, 3, 3), False,
                  tuning.for_level(0), 32, 32))
    cases.append(("L5 series 3^3 192->192", levels[5], (3, 3, 3), False,
                  tuning.for_level(5), 192, 192))
    cases.append(("L0 downsample 2^3 32->64", st0, (2, 2, 2), True,
                  tuning.window_r_strided, 32, 64))

    results = {n: [] for n in REPLACES}
    for label, tab, ksz, strided, r, c, co in cases:
        # the plan as the main path builds it (ops.engine), list included
        if strided:
            qst, (plan, _), _ = E.build_downsample_plan(
                tab, ksz, caps[1], backend=E.WINDOW, tuning=tuning)
        else:
            qst, plan = tab, E.build_series_plan(tab, ksz, backend=E.WINDOW,
                                                 window_r=r)
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
            *args, window_r=r, table_cap=tab.capacity), iters=3, warmup=1)
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
                            iters=3, warmup=1)
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
        if c == 1 or label.startswith("L0 series"):
            nb = K._ov_bound(valid)

            def side(base, x, w, kernel=True):
                sargs = (base, x, w, src, dst, kk, valid, nb)
                if not kernel:
                    return K.overflow_apply_plain(*sargs)
                if c == 1:
                    return K.overflow_apply(*sargs)
                return overflow_apply_batched(*sargs)

            got = side(out.clone(), x_int, w_int)
            want = side(out.clone(), x_int, w_int, kernel=False)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"{name} differs from its plain version at {label}")
            base_r = K.window_conv_apply(*rargs, window_r=r)
            err = (side(base_r.clone(), x_real, w_real).float()
                   - side(base_r.clone(), x_real, w_real, kernel=False).float()
                   ).abs().max().item()
            scratch = base_r.clone()
            ms = timed_ms(lambda: side(scratch, x_real, w_real))
            plain_ms = timed_ms(lambda: side(scratch, x_real, w_real, False),
                                iters=3, warmup=1)
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
        emit({"phase": "kernel", "shape": label, "window_r": r,
              "pairs": pairs_total, "overflow_entries": n_ov, **occupancy,
              "rows": {n: v[-1] for n, v in results.items()
                       if v and v[-1]["shape"] == label}})
    return results


def profile_one_batch(cfg, dataset) -> None:
    """Device time by kernel over one bf16 batch through validate(), and
    the share of the wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparseeventid_tpu_torch.train.evaluate import validate

    one = CachedDataset(GRID, {0: dataset.batch([0])}, BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        validate(cfg, dataset=one, device=DEVICE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / wall_ms,
          "top_kernels": [
              {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
               "count": e.count} for e in top]})


def phase_main(dataset, out_dir: Path):
    import numpy as np
    import torch

    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import sidecar as S
    from sparseeventid_tpu_torch.train.evaluate import validate

    out_file = out_dir / "chip_smoke_softmax.npz"
    cfg = load_config("dune3d", [
        "mode=inference", "run.precision=bfloat16",
        f"run.minibatch_size={BATCH}", "framework.sparse_backend=window",
        f"run.seed={SEED}", f"mode.output_file={out_file}",
    ])
    counters = [K.window_plan, K.window_conv_apply, K.overflow_apply,
                S.overflow_apply_batched]
    plains = [K.window_plan_plain, K.window_conv_apply_plain,
              K.overflow_apply_plain]
    # warm-up on the first batch (allocator, cuBLAS handles), then the run
    warm = CachedDataset(GRID, {0: dataset.batch([0])}, BATCH)
    validate(cfg, dataset=warm, device=DEVICE)
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = validate(cfg, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    plain_calls = {f.__name__: f.calls for f in plains}
    require(np.isfinite(metrics["loss/loss"]), f"loss not finite: {metrics}")
    require(metrics["overflow/dropped"] == 0, f"dropped pairs: {metrics}")
    require(all(v > 0 for v in launches.values()), f"kernel not launched: {launches}")
    require(all(v == 0 for v in plain_calls.values()),
            f"plain version called on the main path: {plain_calls}")
    soft = np.load(out_file)
    for k, n in OUTPUT_SHAPE.items():
        require(soft[k].shape == (BATCH * N_BATCHES, n), f"softmax {k} shape")
        require(np.all(np.isfinite(soft[k])), f"softmax {k} not finite")
    events = BATCH * N_BATCHES
    emit({"phase": "main", "events": events, "seconds": seconds,
          "events_per_s": events / seconds, "metrics": metrics,
          "launches": launches, "launches_per_forward":
          {k: v / N_BATCHES for k, v in launches.items()},
          "plain_calls": plain_calls,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    profile_one_batch(cfg, dataset)
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
        launches = phase_main(dataset, out_dir)
        phase_fp32(dataset)
        kernels = []
        for kname, per_shape in rows.items():
            require(per_shape, f"no measurement of {kname}")
            # headline: the busiest conv level (level 0) where measured
            head = next(
                (r for r in per_shape if r["shape"].startswith("L0 series")),
                per_shape[0],
            )
            kernels.append(dict(
                name=kname, route="cuda", source=SOURCES[kname],
                replaces=REPLACES[kname], launches=launches[kname],
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
