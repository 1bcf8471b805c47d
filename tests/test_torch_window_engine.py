"""The port's window engine (plans built on the device, forward convs)
against the JAX window engine (interpret mode) and the JAX XLA backend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, line_coo, random_coo, t

from sparseeventid_tpu import ops as jops
from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.rulebook import build_downsample_rulebook as jdr
from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
from sparseeventid_tpu.ops.rulebook import kernel_offsets
from sparseeventid_tpu_torch.ops import engine as teng
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import engine as twe
from sparseeventid_tpu_torch.ops.window import query as tq

PLAN_FIELDS = ("qmeta", "start", "q_active", "ov_src", "ov_dst", "ov_k",
               "ov_valid", "ov_dropped")


def _assert_plans_equal(pt, pj):
    for f in PLAN_FIELDS:
        assert_equal(getattr(pt, f), getattr(pj, f))
    assert pt.offsets == pj.offsets
    assert pt.dkeys == pj.dkeys
    assert pt.window_r == pj.window_r
    assert pt.q_bound == pj.q_bound


@pytest.mark.parametrize("geometry", ["random", "forced_overflow"])
def test_submanifold_plan_fields_bit_equal(geometry):
    if geometry == "random":
        coords, feats = random_coo(1, n=512, grid=(12, 12, 12), c=4,
                                   density=0.25, n_live=[400, 0])
        grid, r, cap = (12, 12, 12), 160, 2048
    else:
        (coords, feats, grid), r, cap = line_coo(), 32, 64
    sj, st = both(coords, feats, grid)
    pj = jwe.build_submanifold_window_plan(
        sj, (3, 3, 3), overflow_cap=cap, interpret=True, window_r=r
    )
    pt = twe.build_submanifold_window_plan(
        st, (3, 3, 3), window_r=r, overflow_cap=cap
    )
    _assert_plans_equal(pt, pj)
    if geometry == "forced_overflow":  # the cap clamps: drops are counted
        assert int(pt.ov_dropped.sum()) > 0


def test_strided_plans_bit_equal():
    coords, feats = random_coo(2, n=512, grid=(16, 16, 16), c=4, density=0.1)
    sj, st = both(coords, feats, (16, 16, 16))
    skj = jds(sj, (2, 2, 2), 512)
    skt = trb.downsample_sites(st, (2, 2, 2), 512)
    fj, rj = jwe.build_strided_window_plans(sj, skj, (2, 2, 2), interpret=True)
    ft, rt = twe.build_strided_window_plans(st, skt, (2, 2, 2),
                                            overflow_cap=2048)
    assert (ft.window_r, rt.window_r) == (320, 160)
    _assert_plans_equal(ft, fj)
    _assert_plans_equal(rt, rj)


@pytest.mark.parametrize("which", ["initial 5^3", "series 3^3", "downsample 2^3"])
def test_engine_plans_are_level_wide_and_bit_equal(which):
    """ops.engine sets the overflow-list width (the level capacity) and its
    plans equal the JAX builders' given that width."""
    coords, feats = random_coo(8, n=512, grid=(16, 16, 16), c=1, density=0.1)
    sj, st = both(coords, feats, (16, 16, 16))
    cap = teng.device_list_width(st.capacity)
    if which == "downsample 2^3":
        _, (ft, rt), _ = teng.build_downsample_plan(
            st, (2, 2, 2), 512, backend=teng.WINDOW)
        fj, rj = jwe.build_strided_window_plans(
            sj, jds(sj, (2, 2, 2), 512), (2, 2, 2), overflow_cap=cap,
            interpret=True)
        pairs = ((ft, fj), (rt, rj))
    else:
        ksz, r = ((5, 5, 5), 176) if which == "initial 5^3" else ((3, 3, 3), 160)
        pt = teng.build_series_plan(st, ksz, backend=teng.WINDOW, window_r=r)
        pj = jwe.build_submanifold_window_plan(
            sj, ksz, overflow_cap=cap, interpret=True, window_r=r)
        pairs = ((pt, pj),)
    for pt, pj in pairs:
        assert pt.ov_valid.shape[1] == cap == st.capacity
        _assert_plans_equal(pt, pj)


@pytest.mark.parametrize("ksz", [(3, 3, 3), (5, 5, 5)])
def test_query_meta_bit_equal(ksz):
    """Packed qmeta (base key + validity words, bit 31 included at 5^3) and
    its expansion equal the JAX arrays, for submanifold, strided forward and
    reverse queries."""
    coords, feats = random_coo(3, n=128, grid=(8, 8, 8), c=1, density=0.3)
    sj, st = both(coords, feats, (8, 8, 8))
    offs = kernel_offsets(ksz, centered=True)
    mj = jwc.compute_query_meta(sj, offs)
    mt = tq.compute_query_meta(st, offs)
    assert_equal(mt, mj)
    dk = tq.key_deltas(st.grid_shape, offs)
    assert dk == jwc.key_deltas(sj.grid_shape, offs)
    assert_equal(tq.materialize_qkeys(mt, dk), jwc.materialize_qkeys(mj, dk))
    assert_equal(
        tq.materialize_qkeys(mt, dk),
        np.asarray(jwc.compute_query_keys(sj, offs)).transpose(0, 2, 1),
    )
    skj = jds(sj, (2, 2, 2), 128)
    skt = trb.downsample_sites(st, (2, 2, 2), 128)
    d_offs = kernel_offsets((2, 2, 2), centered=False)
    assert_equal(
        tq.compute_strided_query_meta(skt, st.grid_shape, (2, 2, 2), d_offs),
        jwc.compute_strided_query_meta(skj, sj.grid_shape, (2, 2, 2), d_offs),
    )
    assert_equal(
        tq.compute_reverse_query_meta(st, skt, (2, 2, 2), 8),
        jwc.compute_reverse_query_meta(sj, skj, (2, 2, 2), 8),
    )


def _subm_pair(integer, geometry):
    if geometry == "random":
        coords, feats = random_coo(4, n=512, grid=(12, 12, 12), c=8,
                                   density=0.25, integer=integer)
        grid, r = (12, 12, 12), 160
    else:
        coords, feats, grid = line_coo(c=8)
        r = 32
    return both(coords, feats, grid), r


@pytest.mark.parametrize("geometry", ["random", "forced_overflow"])
@pytest.mark.parametrize("integer", [True, False])
def test_window_submanifold_conv_matches_jax(integer, geometry):
    (sj, st), r = _subm_pair(integer, geometry)
    rng = np.random.default_rng(7)
    if integer:
        w = int_weights(8, (27, 8, 16))
        bias = rng.integers(-2, 3, 16).astype(np.float32)
    else:
        w = (rng.standard_normal((27, 8, 16)) * 0.2).astype(np.float32)
        bias = rng.standard_normal(16).astype(np.float32)
    pj = jwe.build_submanifold_window_plan(sj, (3, 3, 3), interpret=True,
                                           window_r=r)
    want = jwe.window_submanifold_conv(sj, pj, jnp.asarray(w),
                                       jnp.asarray(bias), interpret=True)
    ref = jops.submanifold_conv(
        sj, jops.build_submanifold_rulebook(sj, (3, 3, 3)), jnp.asarray(w),
        jnp.asarray(bias),
    )
    pt = twe.build_submanifold_window_plan(st, (3, 3, 3), window_r=r,
                                           overflow_cap=2048)
    if geometry == "forced_overflow":
        assert int(pt.ov_valid.sum()) > 0
    with torch.no_grad():
        got = twe.window_submanifold_conv(
            st, pt, torch.from_numpy(w), torch.from_numpy(bias)
        ).feats
    if integer:
        assert_equal(got, want.feats)
        assert_equal(got, ref.feats)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.feats),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.feats),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("integer", [True, False])
def test_window_strided_conv_matches_jax(integer):
    coords, feats = random_coo(5, n=512, grid=(16, 16, 16), c=8,
                               density=0.1, integer=integer)
    sj, st = both(coords, feats, (16, 16, 16))
    rng = np.random.default_rng(11)
    w = (int_weights(12, (8, 8, 16)) if integer
         else (rng.standard_normal((8, 8, 16)) * 0.3).astype(np.float32))
    skj = jds(sj, (2, 2, 2), 512)
    fj, rj = jwe.build_strided_window_plans(sj, skj, (2, 2, 2), interpret=True)
    want = jwe.window_strided_conv(sj, skj, fj, rj, jnp.asarray(w),
                                   interpret=True)
    ref = jops.strided_conv(
        sj, skj, jdr(sj, skj, (2, 2, 2)),
        jnp.asarray(w),
    )
    skt = trb.downsample_sites(st, (2, 2, 2), 512)
    ft, rt = twe.build_strided_window_plans(st, skt, (2, 2, 2),
                                            overflow_cap=2048)
    with torch.no_grad():
        got = twe.window_strided_conv(st, skt, ft, rt, torch.from_numpy(w)).feats
    if integer:
        assert_equal(got, want.feats)
        assert_equal(got, ref.feats)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want.feats),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref.feats),
                                   rtol=1e-4, atol=1e-4)


def test_window_conv_under_autograd_equals_plain_backend():
    """Under autograd the conv returns the plain rulebook backend's
    gradients (bit for bit on integer data).  What raises is a second
    backward through its saved tensors."""
    coords, feats = random_coo(6, n=128, grid=(8, 8, 8), c=2, density=0.1)
    _, st = both(coords, feats, (8, 8, 8))
    plan = twe.build_submanifold_window_plan(st, (3, 3, 3), window_r=160,
                                             overflow_cap=2048)
    rb = trb.build_submanifold_rulebook(st, (3, 3, 3))
    w0 = torch.from_numpy(int_weights(3, (27, 2, 4)))
    grads = []
    for conv in (lambda s, w: twe.window_submanifold_conv(s, plan, w),
                 lambda s, w: teng.apply_submanifold(s, rb, w)):
        x = st.feats.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = conv(st.with_feats(x), w).feats
        out.sum().backward()
        grads.append((x.grad, w.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert float(grads[0][1].abs().sum()) > 0
    with pytest.raises(RuntimeError, match="backward through the graph a second"):
        out.sum().backward()
