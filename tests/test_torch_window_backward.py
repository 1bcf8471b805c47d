"""The port's backward kernels' plain versions, and the conv autograd
Functions built on them, against the JAX package (Pallas kernels in
interpret mode, ``jax.grad`` of the window engine).

Plans are built once by the port with windows narrow enough that their
overflow lists are non-empty, and handed to the JAX side field for field
(tests/test_torch_window_engine.py holds the two builders bit-equal).  On
CPU tensors the port's wrappers run their plain versions; the CUDA kernels
are held against these on the card by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, line_coo, random_coo

from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.pallas import window_sidecar as jws
from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import engine as twe
from sparseeventid_tpu_torch.ops.window import kernels as tk
from sparseeventid_tpu_torch.ops.window.query import WindowTuning
from sparseeventid_tpu_torch.ops.window.sidecar import overflow_dw_batched

NARROW = WindowTuning(window_r=16, window_r_strided=16)


def jax_plan(p: twe.WindowPlan) -> jwe.WindowPlan:
    """The port's plan as a JAX WindowPlan, field for field."""
    arrays = {
        f: jnp.asarray(getattr(p, f).numpy())
        for f in ("qmeta", "start", "q_active", "ov_src", "ov_dst", "ov_k",
                  "ov_valid", "ov_dropped")
    }
    return jwe.WindowPlan(**arrays, offsets=p.offsets, dkeys=p.dkeys,
                          window_r=p.window_r, q_bound=p.q_bound)


def subm_case(c, ksz=(3, 3, 3), integer=True):
    """Forced-overflow geometry, one event -> (JAX st, port st, port plan)."""
    coords, feats, grid = line_coo(c=c)
    if not integer:
        rng = np.random.default_rng(21)
        feats = np.where(coords[..., :1] >= 0,
                         rng.standard_normal(feats.shape), 0).astype(np.float32)
    sj, st = both(coords, feats, grid)
    plan = twe.build_submanifold_window_plan(st, ksz, window_r=32,
                                             overflow_cap=4096)
    assert int(plan.ov_valid.sum()) > 0 and int(plan.ov_dropped.sum()) == 0
    return sj, st, plan


def strided_case(c, integer=True):
    """Two events, the second shorter -> (sj, st, skj, skt, fwd, rev), both
    plans with non-empty overflow lists."""
    coords, feats = random_coo(5, n=512, grid=(16, 16, 16), c=c, density=0.1,
                               integer=integer, n_live=[409, 300])
    sj, st = both(coords, feats, (16, 16, 16))
    skj = jds(sj, (2, 2, 2), 512)
    skt = trb.downsample_sites(st, (2, 2, 2), 512)
    fwd, rev = twe.build_strided_window_plans(
        st, skt, (2, 2, 2), overflow_cap=2048, tuning=NARROW)
    for p in (fwd, rev):
        assert int(p.ov_valid.sum()) > 0 and int(p.ov_dropped.sum()) == 0
    return sj, st, skj, skt, fwd, rev


def int_gy(seed, shape, mask):
    g = np.random.default_rng(seed).integers(-2, 3, shape).astype(np.float32)
    return g * mask[..., None]


# ---- (a) plain versions against the JAX kernels, integer data, bit for bit

def test_window_bwd_strided_bit_equal():
    sj, st, skj, skt, _, rev = strided_case(c=16)
    w = int_weights(3, (8, 16, 32))
    gy = int_gy(4, (2, 512, 32), np.asarray(skj.row_mask()))
    dx_j, dw_j = jwc.window_bwd_strided(
        skj.keys(), jnp.asarray(gy), sj.feats, jnp.asarray(rev.qmeta.numpy()),
        jnp.asarray(rev.start.numpy()), jnp.asarray(w), sj.n_active,
        dkeys=rev.dkeys, interpret=True, window_r=rev.window_r,
    )
    dx, dw = tk.window_bwd_strided(
        skt.keys(), torch.from_numpy(gy), st.feats, rev.qmeta, rev.start,
        torch.from_numpy(w), st.n_active, rev.dkeys, window_r=rev.window_r,
    )
    assert_equal(dx, dx_j)
    assert_equal(dw, dw_j)
    assert dw.dtype == torch.float32 and float(dw.abs().sum()) > 0
    assert float(dx.abs().sum()) > 0


def test_window_bwd_subm_bit_equal():
    sj, st, plan = subm_case(c=16)
    w = int_weights(5, (27, 16, 32))
    gy = int_gy(6, (1, sj.capacity, 32), np.asarray(sj.row_mask()))
    perm = jwe._mirror_perm(plan.offsets)
    assert tuple(int(p) for p in perm) == twe._mirror_perm(plan.offsets)
    dx_j, dw_j = jwc.window_bwd_subm(
        sj.keys(), sj.feats, jnp.asarray(gy), jnp.asarray(plan.qmeta.numpy()),
        jnp.asarray(plan.start.numpy()), jnp.asarray(w), sj.n_active, perm,
        dkeys=plan.dkeys, interpret=True, window_r=plan.window_r,
    )
    dx, dw = tk.window_bwd_subm(
        st.keys(), st.feats, torch.from_numpy(gy), plan.qmeta, plan.start,
        torch.from_numpy(w), st.n_active, perm, plan.dkeys,
        window_r=plan.window_r,
    )
    assert_equal(dx, dx_j)
    assert_equal(dw, dw_j)
    assert float(dw.abs().sum()) > 0


def test_window_bwd_subm_c192_matches_jax():
    """The deep levels' width, C = CO = 192 (the dX kernel's widest slab and
    nine 64 x 64 pieces of dw an offset), on the forced-overflow grid."""
    sj, st, plan = subm_case(c=192)
    w = int_weights(15, (27, 192, 192))
    gy = int_gy(16, (1, sj.capacity, 192), np.asarray(sj.row_mask()))
    perm = jwe._mirror_perm(plan.offsets)
    dx_j, dw_j = jwc.window_bwd_subm(
        sj.keys(), sj.feats, jnp.asarray(gy), jnp.asarray(plan.qmeta.numpy()),
        jnp.asarray(plan.start.numpy()), jnp.asarray(w), sj.n_active, perm,
        dkeys=plan.dkeys, interpret=True, window_r=plan.window_r,
    )
    dx, dw = tk.window_bwd_subm(
        st.keys(), st.feats, torch.from_numpy(gy), plan.qmeta, plan.start,
        torch.from_numpy(w), st.n_active, perm, plan.dkeys,
        window_r=plan.window_r,
    )
    assert_equal(dx, dx_j)
    assert_equal(dw, dw_j)
    assert float(dx.abs().sum()) > 0 and float(dw.abs().sum()) > 0


@pytest.mark.parametrize("entry", ["strided", "subm"])
def test_dx_is_the_conv_through_the_backward_plan(entry):
    """The dX kernel's identity: dx of the backward equals the forward conv
    of gy through the backward plan with the weights the wrapper builds,
    ``_bwd_weights`` (w, or w[perm] for the submanifold twin, transposed
    to [K, CO, C]); that argument equals the JAX package's w[perm]^T."""
    if entry == "strided":
        sj, st, skj, skt, _, plan = strided_case(c=16)
        gy_st, x_st, perm = skt, st, None
        w = int_weights(17, (8, 16, 32))
    else:
        sj, st, plan = subm_case(c=16)
        gy_st, x_st = st, st
        perm = twe._mirror_perm(plan.offsets)
        w = int_weights(18, (27, 16, 32))
    gy = torch.from_numpy(int_gy(19, (gy_st.batch_size, gy_st.capacity, 32),
                                 gy_st.row_mask().numpy()))
    w_t = tk._bwd_weights(torch.from_numpy(w), perm)
    want_t = np.transpose(w if perm is None else w[list(perm)], (0, 2, 1))
    assert w_t.is_contiguous() and w_t.shape == (w.shape[0], 32, 16)
    assert_equal(w_t, jnp.asarray(want_t))
    wk = torch.from_numpy(w if perm is None else w[list(perm)])
    dx, _ = tk.window_bwd_strided(
        gy_st.keys(), gy, x_st.feats, plan.qmeta, plan.start, wk,
        plan.q_active, plan.dkeys, window_r=plan.window_r)
    conv = tk.window_conv_apply_plain(
        gy_st.keys(), gy, plan.qmeta, plan.start, w_t, plan.q_active,
        plan.dkeys, window_r=plan.window_r)
    assert torch.equal(dx, conv) and float(dx.abs().sum()) > 0


# (M input rows, K, C, CO, dX groups, dW parts) of every backward of both
# recipes at 8 events: the series convs of levels 0-5 and the downsamples
BWD_SHAPES = [
    ("L0 series", 50176, 27, 32, 32, 1, 118),
    ("L1 series", 25088, 27, 64, 64, 1, 30),
    ("L2 series", 12800, 27, 96, 96, 2, 14),
    ("L3 series", 6656, 27, 128, 128, 4, 8),
    ("L4 series", 3584, 27, 160, 160, 4, 5),
    ("L5 series", 2048, 27, 192, 192, 4, 4),
    ("L0 downsample", 50176, 8, 32, 64, 1, 198),
    ("L4 downsample", 3584, 8, 160, 192, 1, 14),
    ("2d L0 series", 60416, 9, 32, 32, 1, 352),
    ("2d L4 series", 4096, 9, 160, 160, 1, 15),
    ("2d L5 series", 2048, 9, 192, 192, 2, 10),
    ("2d L0 downsample", 60416, 4, 32, 64, 1, 396),
]


@pytest.mark.parametrize("label,m,k,c,co,groups,parts", BWD_SHAPES)
def test_bwd_launch_geometry(label, m, k, c, co, groups, parts):
    """The wrapper's picks for the backward on 132 SMs: dX's cluster size is
    the conv's rule with the channel counts swapped (it is the conv of gy
    into dx); dW's parts fill about 24 warps an SM over the (offset,
    32 x 32) pieces a warp owns, with no more parts than query tiles and
    the float32 scratch within 64 MB."""
    assert tk._conv_groups(132, 8, m, k, co, c) == groups
    p = tk._bwd_dw_parts(132, 8, m, k, c, co)
    assert p == parts
    pieces = k * -(-c // 32) * -(-co // 32)
    assert 1 <= p <= 8 * -(-m // 128)
    assert p * k * c * co * 4 <= 64 << 20
    assert p * pieces >= 24 * 132


# (label, B, M, K, C, CO, parts, groups) of window_dw on 132 SMs: both
# recipes' initial convs, a SimCLR view's, the deconv's shape (the tiled
# route) and a single tile
DW_SHAPES = [
    ("initial 5^3", 8, 50176, 125, 1, 32, 396, 1),
    ("2d initial", 8, 60416, 25, 1, 32, 396, 1),
    ("SimCLR view initial", 8, 3072, 125, 1, 32, 192, 2),
    ("one tile", 1, 100, 125, 1, 32, 1, 8),
    ("deconv L1->L0", 8, 50176, 8, 64, 32, 33, 1),
]


@pytest.mark.parametrize("label,b,m,k,c,co,parts,groups", DW_SHAPES)
def test_window_dw_geometry(label, b, m, k, c, co, parts, groups):
    """window_dw's grid: the C == 1 route (three blocks an SM) shares the
    query tiles among at most as many parts as tiles and splits the
    offsets into groups (at most 8) where the tiles are too few to fill the
    card; the tiled route takes one group and about four blocks an SM over
    its pieces.  ordered_sum then reads parts rows of K * C * CO partials,
    a scratch far within the dW kernels' 64 MB."""
    got = tk._dw_parts(132, b, m, k, c, co)
    assert got == (parts, groups)
    tiles = b * -(-m // 128)
    assert 1 <= parts <= tiles and 1 <= groups <= 8
    if c == 1:
        assert parts * groups <= 3 * 132 + groups
    assert parts * k * c * co * 4 <= tk._SCRATCH_BYTES


@pytest.mark.parametrize("name,ksz,c,co,mirror", [
    ("initial_k125_c1", (5, 5, 5), 1, 32, False),
    ("k27_c16_kmap", (3, 3, 3), 16, 16, True),
])
def test_window_dw_bit_equal(name, ksz, c, co, mirror):
    sj, st, plan = subm_case(c=c, ksz=ksz)
    gy = int_gy(8, (1, sj.capacity, co), np.asarray(sj.row_mask()))
    kmap = twe._mirror_perm(plan.offsets) if mirror else None
    want = jwc.window_dw(
        sj.keys(), sj.feats, jnp.asarray(plan.qmeta.numpy()),
        jnp.asarray(plan.start.numpy()), jnp.asarray(gy), sj.n_active,
        plan.dkeys, kmap=kmap, interpret=True, window_r=plan.window_r,
    )
    got = tk.window_dw(
        st.keys(), st.feats, plan.qmeta, plan.start, torch.from_numpy(gy),
        st.n_active, plan.dkeys, kmap, window_r=plan.window_r,
    )
    assert_equal(got, want)
    assert got.shape == (len(plan.dkeys), c, co) and float(got.abs().sum()) > 0


@pytest.mark.parametrize("entry", ["batched", "serial_c1"])
def test_overflow_dw_bit_equal(entry):
    """``overflow_dw_batched`` against its Pallas kernel; ``overflow_dw``
    (C == 1) against the engine's XLA twin, which is what the JAX package
    runs for it in interpret mode."""
    c = 16 if entry == "batched" else 1
    sj, st, plan = subm_case(c=c)
    gy = int_gy(9, (1, sj.capacity, 32), np.asarray(sj.row_mask()))
    pj = jax_plan(plan)
    if entry == "batched":
        want = jws.overflow_dw_batched(
            sj.feats, jnp.asarray(gy), 27, pj.ov_src, pj.ov_dst, pj.ov_k,
            pj.ov_valid, jwc._ov_bound(pj.ov_valid), interpret=True,
        )
        got = overflow_dw_batched(
            st.feats, torch.from_numpy(gy), 27, plan.ov_src, plan.ov_dst,
            plan.ov_k, plan.ov_valid, tk._ov_bound(plan.ov_valid),
        )
    else:
        want = jwe._overflow_dw(sj.feats, jnp.asarray(gy), pj.ov_src,
                                pj.ov_dst, pj.ov_k, pj.ov_valid, 27)
        got = tk.overflow_dw(st.feats, torch.from_numpy(gy), 27, plan.ov_src,
                             plan.ov_dst, plan.ov_k, plan.ov_valid)
    assert_equal(got, want)
    assert float(got.abs().sum()) > 0


def test_overflow_dw_empty_list_is_zero():
    z = torch.zeros((1, 5), dtype=torch.int32)
    got = tk.overflow_dw(torch.ones((1, 3, 2)), torch.ones((1, 4, 6)), 7,
                         z, z, z, torch.zeros((1, 5), dtype=torch.bool))
    assert got.shape == (7, 2, 6) and float(got.abs().sum()) == 0.0


def test_backward_wrappers_count_plain_calls_not_launches():
    sj, st, plan = subm_case(c=1)
    gy = torch.from_numpy(int_gy(9, (1, sj.capacity, 8), np.asarray(sj.row_mask())))
    pairs = [(tk.window_dw, tk.window_dw_plain),
             (tk.overflow_dw, tk.overflow_dw_plain),
             (tk.window_bwd_strided, tk.window_bwd_strided_plain)]
    before = [(w.launches, p.calls) for w, p in pairs]
    tk.window_dw(st.keys(), st.feats, plan.qmeta, plan.start, gy, st.n_active,
                 plan.dkeys, window_r=plan.window_r)
    tk.overflow_dw(st.feats, gy, 27, plan.ov_src, plan.ov_dst, plan.ov_k,
                   plan.ov_valid)
    tk.window_bwd_strided(st.keys(), gy, st.feats, plan.qmeta, plan.start,
                          torch.zeros((27, 1, 8)), st.n_active, plan.dkeys,
                          window_r=plan.window_r)
    for (w, p), (launches, calls) in zip(pairs, before):
        assert w.launches == launches and p.calls == calls + 1


# ---- (b) dX, dW of the conv Functions against jax.grad, fp32

RTOL, ATOL = 1e-3, 1e-4  # the limits of tests/test_window_engine.py


def _torch_grads(conv, feats, w):
    x = feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (conv(x, wt).feats ** 2).sum().backward()
    return x.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("name,c,co,ksz", [
    ("fused_c16", 16, 32, (3, 3, 3)),
    ("c1_initial", 1, 16, (5, 5, 5)),
])
def test_submanifold_conv_grads_match_jax(name, c, co, ksz):
    sj, st, plan = subm_case(c=c, ksz=ksz, integer=False)
    k = len(plan.dkeys)
    assert jwe._fused_bwd_ok(k, c, co) == (c > 1)
    rng = np.random.default_rng(12)
    w = (rng.standard_normal((k, c, co)) * 0.2).astype(np.float32)
    pj = jax_plan(plan)

    def loss(wj, f):
        return jnp.sum(jwe.window_submanifold_conv(
            sj.with_feats(f), pj, wj, interpret=True).feats ** 2)

    gw_j, gx_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), sj.feats)
    gx, gw = _torch_grads(
        lambda x, wt: twe.window_submanifold_conv(st.with_feats(x), plan, wt),
        st.feats, w)
    np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gx, np.asarray(gx_j), rtol=RTOL, atol=ATOL)
    assert float(np.abs(gw).sum()) > 0 and float(np.abs(gx).sum()) > 0


def test_strided_conv_grads_match_jax():
    sj, st, skj, skt, fwd, rev = strided_case(c=16, integer=False)
    assert jwe._fused_bwd_ok(8, 16, 32)
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((8, 16, 32)) * 0.3).astype(np.float32)
    fj, rj = jax_plan(fwd), jax_plan(rev)

    def loss(wj, f):
        return jnp.sum(jwe.window_strided_conv(
            sj.with_feats(f), skj, fj, rj, wj, interpret=True).feats ** 2)

    gw_j, gx_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), sj.feats)
    gx, gw = _torch_grads(
        lambda x, wt: twe.window_strided_conv(st.with_feats(x), skt, fwd, rev, wt),
        st.feats, w)
    np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gx, np.asarray(gx_j), rtol=RTOL, atol=ATOL)


# ---- the twin complement: integer-exact against the plain rulebook backend

def _exact_grads(conv, feats, w, gy):
    x = feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    conv(x, wt).feats.backward(gy)
    return x.grad, wt.grad


@pytest.mark.parametrize("case", ["subm_fused", "subm_c1", "strided"])
def test_conv_grads_equal_plain_backend_exactly(case):
    """Integer-valued data: dX and dW of the window Functions equal the
    plain rulebook backend's autograd bit for bit, overflow lists non-empty.
    Any pair counted twice or lost by a sidecar breaks the equality."""
    from sparseeventid_tpu_torch.ops import conv as tc

    if case == "strided":
        _, st, _, skt, fwd, rev = strided_case(c=8)
        rb = trb.build_downsample_rulebook(st, skt, (2, 2, 2))
        w = int_weights(14, (8, 8, 16))
        win = lambda x, wt: twe.window_strided_conv(st.with_feats(x), skt, fwd, rev, wt)
        ref = lambda x, wt: tc.strided_conv(st.with_feats(x), skt, rb, wt)
        mask = skt.row_mask()
    else:
        c = 8 if case == "subm_fused" else 1
        _, st, plan = subm_case(c=c)
        rb = trb.build_submanifold_rulebook(st, (3, 3, 3))
        w = int_weights(15, (27, c, 16))
        win = lambda x, wt: twe.window_submanifold_conv(st.with_feats(x), plan, wt)
        ref = lambda x, wt: tc.submanifold_conv(st.with_feats(x), rb, wt)
        mask = st.row_mask()
    gy = torch.from_numpy(int_gy(16, (*mask.shape, 16), mask.numpy()))
    got = _exact_grads(win, st.feats, w, gy)
    want = _exact_grads(ref, st.feats, w, gy)
    for g, r in zip(got, want):
        assert torch.equal(g, r) and float(g.abs().sum()) > 0


@pytest.mark.parametrize("fault", ["dw_sidecar_skipped", "twin_list_transposed"])
def test_exact_check_catches_planted_faults(fault, monkeypatch):
    """The two ways the backward's overflow complement has gone wrong must
    break the integer-exact equality: the dW sidecar left out, and the twin
    list transposed where the weights should be permuted."""
    from sparseeventid_tpu_torch.ops import conv as tc

    _, st, plan = subm_case(c=8)
    rb = trb.build_submanifold_rulebook(st, (3, 3, 3))
    w = int_weights(15, (27, 8, 16))
    gy = torch.from_numpy(int_gy(16, (1, st.capacity, 16), st.row_mask().numpy()))
    want = _exact_grads(
        lambda x, wt: tc.submanifold_conv(st.with_feats(x), rb, wt),
        st.feats, w, gy)
    if fault == "dw_sidecar_skipped":
        monkeypatch.setattr(
            twe, "_overflow_dw",
            lambda x, g, src, dst, p: torch.zeros(
                (p.num_offsets, x.shape[-1], g.shape[-1])))
        broken = 1  # dW
    else:
        apply = twe._apply_overflow
        perm = torch.as_tensor(twe._mirror_perm(plan.offsets))

        def transposed(out, table, wt, p):
            if out.shape[-1] == 8:  # the dX call (the forward's has CO = 16)
                p = dataclasses.replace(p, ov_src=p.ov_dst, ov_dst=p.ov_src)
                wt = wt[perm].contiguous()  # undo the permutation
            return apply(out, table, wt, p)

        monkeypatch.setattr(twe, "_apply_overflow", transposed)
        broken = 0  # dX
    got = _exact_grads(
        lambda x, wt: twe.window_submanifold_conv(st.with_feats(x), plan, wt),
        st.feats, w, gy)
    assert not torch.equal(got[broken], want[broken])
    assert torch.equal(got[1 - broken], want[1 - broken])
