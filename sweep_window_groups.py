#!/usr/bin/env python3
"""Sweep the launch geometry of the window kernels on one NVIDIA card.

    python3 sweep_window_groups.py [--gather-conv]

For the initial conv and every series level of the dune3d and dune2d
recipes (chip_smoke.py's synthetic batch 0, bf16), times window_plan with
each group size G (offsets a block takes) and the tensor-core
window_conv_apply with each cluster size (blocks that share a tile's
offsets), next to the size the wrappers pick (kernels._plan_group,
kernels._conv_groups); then the backward (window_bwd_subm's kernels) with
each dX cluster size and with dW's parts (warps that share a piece's
tiles) at the pick, half and twice it, four times it and 1, beside the
wrapper's picks (kernels._conv_groups with the channels swapped,
kernels._bwd_dw_parts); and, on the lists of the initial and level-0
plans, the dW sidecar with 16 to 512 parts beside kernels._ov_dw_parts.
With --gather-conv, only the bf16 gather_conv over the submanifold
rulebook of every dune3d series level with each cluster size, beside
gather_conv.gather_groups (within one bf16 ulp of the wrapper's result).
Every plan must equal the wrapper's bit for bit, every conv and dX stay
within one bf16 ulp of it (the cluster's partial sums add in another
order), the sidecar's dW within 1e-4 of its scale and the backward's
within 1e-3 (at one part it sums thousands of tiles in one float32 run).
Prints the card's name and power limit, then one JSON line per shape;
exits non-zero on a mismatch or without a CUDA device.
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs

PLAN_GROUPS = (8, 16, 24, 32)
CONV_GROUPS = (1, 2, 4, 8)
OV_PARTS = (16, 32, 64, 128, 256, 512)


def sweep(geo, dataset) -> None:
    import torch

    from sparseeventid_tpu_torch import io as port_io
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import engine as E
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import _native
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window import query as Q

    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_fn = _native.lib("window_plan").seid_window_plan
    conv_fn = _native.lib("window_conv").seid_window_conv_bf16
    caps = capacity_schedule(geo["rows"], 5, 0.5, 1024)
    levels = [getattr(port_io, geo["to_sparse"])(
        dataset.batch([0])["image"], geo["grid"], capacity=caps[0], device=dev)]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], geo["stride"], cap))
    tuning = Q.WindowTuning()
    cases = [("initial", levels[0], geo["initial"], tuning.window_r_initial, 1, 32)]
    cases += [(f"L{lv} series", levels[lv], geo["series"], tuning.for_level(lv),
               32 * (lv + 1), 32 * (lv + 1)) for lv in range(6)]
    for label, st, ksz, r, c, co in cases:
        plan = E.build_series_plan(st, ksz, backend=E.WINDOW, window_r=r)
        offs = rb.kernel_offsets(ksz, centered=True)
        qkeys = Q.compute_query_keys(st, offs)
        keys, k = st.keys(), len(offs)
        pk = Q._padded_table(keys)
        b, npad = pk.shape
        m = st.capacity
        n_tiles = Q._cdiv(m, Q.TILE_T)
        row = {"shape": geo["prefix"] + label, "tiles": b * n_tiles,
               "live_tiles": int(((st.n_active + Q.TILE_T - 1) // Q.TILE_T).sum()),
               "plan_pick": K._plan_group(sms, b, n_tiles, k)}
        start, uncov = K.window_plan(pk, qkeys, st.n_active, window_r=r,
                                     table_cap=st.capacity)
        s_, u_ = torch.empty_like(start), torch.empty_like(uncov)

        def run_plan(g):
            err = plan_fn(pk.data_ptr(), npad, qkeys.data_ptr(), m, k,
                          st.n_active.data_ptr(), s_.data_ptr(), u_.data_ptr(),
                          b, n_tiles, r, Q.conv_max_start(st.capacity, r), g,
                          torch.cuda.current_stream().cuda_stream)
            cs.require(err == 0, f"window_plan: CUDA error {err}")

        for g in sorted({min(g, k) for g in PLAN_GROUPS}):
            run_plan(g)
            torch.cuda.synchronize()
            cs.require(torch.equal(s_, start) and torch.equal(u_, uncov),
                       f"window_plan with G={g} differs at {row['shape']}")
            row[f"plan_ms_G{g}"] = cs.timed_ms(lambda: run_plan(g))
        if c > 1:
            x = (torch.randn((b, m, c), generator=gen, device=dev)
                 * st.row_mask()[..., None]).to(torch.bfloat16).contiguous()
            w = (torch.randn((k, c, co), generator=gen, device=dev)
                 / (k * c) ** 0.5).to(torch.bfloat16).contiguous()
            want = K.window_conv_apply(keys, x, plan.qmeta, plan.start, w,
                                       st.n_active, plan.dkeys, window_r=r)
            out = torch.empty_like(want)
            _, dk, cols = K._offset_args(plan.dkeys, None)
            row["conv_pick"] = K._conv_groups(sms, b, m, k, c, co)

            def run_conv(g):
                err = conv_fn(keys.data_ptr(), m, x.data_ptr(), c,
                              plan.qmeta.data_ptr(), plan.qmeta.shape[1] - 1,
                              m, plan.start.data_ptr(), n_tiles, k,
                              w.data_ptr(), co, st.n_active.data_ptr(), m, r,
                              out.data_ptr(), dk, cols, b, g,
                              torch.cuda.current_stream().cuda_stream)
                cs.require(err == 0, f"window_conv_apply: CUDA error {err}")

            scale = want.float().abs().max().item()
            for g in CONV_GROUPS:
                run_conv(g)
                torch.cuda.synchronize()
                diff = (out.float() - want.float()).abs().max().item()
                cs.require(diff <= cs._bf16_ulp(scale),
                           f"window_conv_apply with {g} blocks a tile differs "
                           f"by {diff} at {row['shape']}")
                row[f"conv_ms_g{g}"] = cs.timed_ms(lambda: run_conv(g))
            sweep_backward(row, st, plan, x, w, gen, sms)
        sweep_overflow_dw(row, st, plan, c, co, gen, sms)
        print(json.dumps(row), flush=True)


def sweep_backward(row, st, plan, x, w, gen, sms) -> None:
    """The submanifold backward on the series plan (gy on the same sites)
    with each dX cluster size and several dW part counts."""
    import torch

    from sparseeventid_tpu_torch.ops.window import _native
    from sparseeventid_tpu_torch.ops.window import kernels as K
    from sparseeventid_tpu_torch.ops.window.engine import _mirror_perm

    dev = x.device
    b, m, c = x.shape
    k, _, co = w.shape
    r = plan.window_r
    keys = st.keys()
    gy = (torch.randn((b, m, co), generator=gen, device=dev)
          * st.row_mask()[..., None]).to(torch.bfloat16).contiguous()
    perm = _mirror_perm(plan.offsets)
    dx_want, dw_want = K.window_bwd_subm(keys, x, gy, plan.qmeta, plan.start, w,
                                         st.n_active, perm, plan.dkeys,
                                         window_r=r)
    w_t = K._bwd_weights(w, perm)
    _, dk, cols = K._offset_args(plan.dkeys, None)
    fn = _native.lib("window_bwd").seid_window_bwd_bf16
    dx, dw = torch.empty_like(dx_want), torch.empty_like(dw_want)
    pick_g = K._conv_groups(sms, b, m, k, co, c)
    pick_p = K._bwd_dw_parts(sms, b, m, k, c, co)
    row["bwd_dx_pick"], row["bwd_dw_parts_pick"] = pick_g, pick_p
    part = torch.empty((max(4 * pick_p, 2), k * c * co), dtype=torch.float32,
                       device=dev)

    def run(g, p):
        err = fn(keys.data_ptr(), m, gy.data_ptr(), co, x.data_ptr(), c,
                 plan.qmeta.data_ptr(), plan.qmeta.shape[1] - 1, m,
                 plan.start.data_ptr(), plan.start.shape[1], k, w_t.data_ptr(),
                 st.n_active.data_ptr(), m, r, dx.data_ptr(), dw.data_ptr(), dk,
                 cols, b, g, part.data_ptr(), p,
                 torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"window_bwd: CUDA error {err}")

    dx_scale = dx_want.float().abs().max().item()
    dw_scale = dw_want.abs().max().item()
    parts = sorted({1, max(1, pick_p // 2), pick_p, 2 * pick_p, 4 * pick_p})
    for g, p in [(g, pick_p) for g in CONV_GROUPS] + [(pick_g, p) for p in parts]:
        run(g, p)
        torch.cuda.synchronize()
        e_dx = (dx.float() - dx_want.float()).abs().max().item()
        e_dw = (dw - dw_want).abs().max().item()
        # one part sums thousands of tiles in one float32 run: 1e-3
        cs.require(e_dx <= cs._bf16_ulp(dx_scale) and e_dw <= 1e-3 * dw_scale,
                   f"window_bwd with {g} dX blocks a tile and {p} dW parts "
                   f"differs by {e_dx}, {e_dw} at {row['shape']}")
        row[f"bwd_ms_g{g}_p{p}"] = cs.timed_ms(lambda: run(g, p))


def sweep_overflow_dw(row, st, plan, c, co, gen, sms) -> None:
    """The dW sidecar over the plan's own list at 16 to 512 parts, where the
    list is long enough to matter (the initial and level-0 plans)."""
    import torch

    from sparseeventid_tpu_torch.ops.window import _native
    from sparseeventid_tpu_torch.ops.window import kernels as K

    valid = plan.ov_valid
    if not (row["shape"].endswith("initial") or row["shape"].endswith("L0 series")):
        return
    dev = valid.device
    b, m = st.batch_size, st.capacity
    k = plan.num_offsets
    x = (torch.randn((b, m, c), generator=gen, device=dev)
         * st.row_mask()[..., None]).to(torch.bfloat16).contiguous()
    gy = (torch.randn((b, m, co), generator=gen, device=dev)
          * st.row_mask()[..., None]).to(torch.bfloat16).contiguous()
    args = (x, gy, k, plan.ov_dst, plan.ov_src, plan.ov_k, valid,
            K._ov_bound(valid))
    want = K.overflow_dw_plain(*args)
    kr, cr = K._ov_dw_piece(k, c, co)
    fn = _native.lib("overflow_dw").seid_overflow_dw_bf16
    out = torch.empty_like(want)
    src, dst, kk, nb = args[3], args[4], args[5], args[7]
    row["ov_dw_entries"] = int(valid.sum())
    row["ov_dw_parts_pick"] = K._ov_dw_parts(sms, k, c, co)
    parts = sorted(set(OV_PARTS) | {row["ov_dw_parts_pick"]})
    part = torch.empty((max(parts), k * c * co), dtype=torch.float32,
                       device=dev)

    def run(p):
        err = fn(out.data_ptr(), k, x.data_ptr(), m, c, gy.data_ptr(), m, co,
                 src.data_ptr(), dst.data_ptr(), kk.data_ptr(),
                 valid.data_ptr(), nb.data_ptr(), src.shape[1], b,
                 part.data_ptr(), p, kr, cr,
                 torch.cuda.current_stream().cuda_stream)
        cs.require(err == 0, f"overflow_dw: CUDA error {err}")

    scale = want.abs().max().item()
    for p in parts:
        run(p)
        torch.cuda.synchronize()
        diff = (out - want).abs().max().item()
        cs.require(diff <= 1e-4 * scale,
                   f"overflow_dw with {p} parts differs by {diff} at {row['shape']}")
        row[f"ov_dw_ms_p{p}"] = cs.timed_ms(lambda: run(p))


def sweep_gather_conv(geo, dataset) -> None:
    """gather_conv (bf16) over the submanifold rulebook of every series
    level with each cluster size, beside the wrapper's pick
    (gather_conv.gather_groups)."""
    import torch

    from sparseeventid_tpu_torch import io as port_io
    from sparseeventid_tpu_torch.models.encoder import capacity_schedule
    from sparseeventid_tpu_torch.ops import gather_conv as GC
    from sparseeventid_tpu_torch.ops import rulebook as rb
    from sparseeventid_tpu_torch.ops.window import _native

    dev = torch.device(cs.DEVICE)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _native.lib("gather_conv").seid_gather_conv_bf16
    caps = capacity_schedule(geo["rows"], 5, 0.5, 1024)
    levels = [getattr(port_io, geo["to_sparse"])(
        dataset.batch([0])["image"], geo["grid"], capacity=caps[0], device=dev)]
    for cap in caps[1:]:
        levels.append(rb.downsample_sites(levels[-1], geo["stride"], cap))
    for lv, st in enumerate(levels):
        c = co = 32 * (lv + 1)
        book = rb.build_submanifold_rulebook(st, geo["series"])
        idx = GC._encode_miss(book, st.capacity)
        b, m, k = idx.shape
        x = (torch.randn((b, m, c), generator=gen, device=dev)
             * st.row_mask()[..., None]).to(torch.bfloat16).contiguous()
        w = (torch.randn((k, c, co), generator=gen, device=dev)
             / (k * c) ** 0.5).to(torch.bfloat16).contiguous()
        want = GC.gather_conv(x, idx, w)
        out = torch.empty_like(want)
        row = {"shape": f"{geo['prefix']}L{lv} series gather_conv",
               "gather_pick": GC.gather_groups(sms, b, m, k, c, co)}

        def run(g):
            err = fn(x.data_ptr(), m, c, idx.data_ptr(), m, k, w.data_ptr(),
                     co, out.data_ptr(), b, g,
                     torch.cuda.current_stream().cuda_stream)
            cs.require(err == 0, f"gather_conv: CUDA error {err}")

        scale = want.float().abs().max().item()
        for g in CONV_GROUPS:
            run(g)
            torch.cuda.synchronize()
            diff = (out.float() - want.float()).abs().max().item()
            cs.require(diff <= cs._bf16_ulp(scale),
                       f"gather_conv with {g} blocks a tile differs by {diff} "
                       f"at {row['shape']}")
            row[f"gather_ms_g{g}"] = cs.timed_ms(lambda: run(g))
        print(json.dumps(row), flush=True)


def main(argv) -> int:
    if argv not in ([], ["--gather-conv"]):
        print("usage: sweep_window_groups.py [--gather-conv]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("sweep_window_groups: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_window_groups: no CUDA device", file=sys.stderr)
        return 2
    try:
        cs.phase_device()
        if argv:
            sweep_gather_conv(cs.GEOMETRY_3D, cs.make_dataset())
            return 0
        sweep(cs.GEOMETRY_3D, cs.make_dataset())
        sweep(cs.GEOMETRY_2D, cs.make_dataset_2d())
    except cs.Failure as e:
        print(f"sweep_window_groups: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
