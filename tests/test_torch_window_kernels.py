"""The window kernels' plain versions in the PyTorch port against the JAX
Pallas kernels (interpret mode) on the same integer-valued inputs: every
result must be bit-equal.  On CPU tensors the port's wrappers run their
plain versions; the CUDA kernels are held against these on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, line_coo, random_coo, t

from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.pallas import window_sidecar as jws
from sparseeventid_tpu.ops.rulebook import kernel_offsets
from sparseeventid_tpu_torch.ops.window import kernels as tk
from sparseeventid_tpu_torch.ops.window import query as tq
from sparseeventid_tpu_torch.ops.window.sidecar import overflow_apply_batched

# (name, kernel size, window rows): the initial 5^3 conv, a series conv, and
# a window narrow enough to push many pairs out of it
PLAN_CASES = [("k125", (5, 5, 5), 176), ("k27", (3, 3, 3), 160),
              ("k27_narrow", (3, 3, 3), 32)]


def _subm_inputs(ksz, seed=0, n_live=None, grid=(12, 12, 12)):
    coords, feats = random_coo(seed, n=512, grid=grid, c=8, density=0.25,
                               n_live=n_live)
    sj, st = both(coords, feats, grid)
    offs = kernel_offsets(ksz, centered=True)
    return sj, st, offs


def _jax_plan(keys_j, qkeys_j, n_active, r, cap):
    pk, _ = jwc._padded_table(keys_j, jnp.zeros((*keys_j.shape, 1)))
    return jwc.window_plan(pk, qkeys_j, n_active, interpret=True,
                           window_r=r, table_cap=cap)


@pytest.mark.parametrize("name,ksz,r", PLAN_CASES)
def test_window_plan_bit_equal(name, ksz, r):
    # batch element 1 is empty: its tiles are all dead
    sj, st, offs = _subm_inputs(ksz, n_live=[300, 0])
    qj = jwc.compute_query_keys(sj, offs)
    start_j, unc_j = _jax_plan(sj.keys(), qj, sj.n_active, r, sj.capacity)
    qt = tq.compute_query_keys(st, offs)
    assert_equal(qt, qj)
    start_t, unc_t = tk.window_plan(
        tq._padded_table(st.keys()), qt, st.n_active, window_r=r,
        table_cap=st.capacity,
    )
    assert_equal(start_t, start_j)
    assert_equal(unc_t, unc_j)
    assert int(start_t[1].abs().sum()) == 0 and int(unc_t[1].sum()) == 0
    if name == "k27_narrow":
        assert int(unc_t.sum()) > 0  # the sidecar has work


def test_window_plan_forced_overflow_geometry():
    coords, feats, grid = line_coo()
    sj, st = both(coords, feats, grid)
    offs = kernel_offsets((3, 3, 3), centered=True)
    qj = jwc.compute_query_keys(sj, offs)
    start_j, unc_j = _jax_plan(sj.keys(), qj, sj.n_active, 32, sj.capacity)
    start_t, unc_t = tk.window_plan(
        tq._padded_table(st.keys()), tq.compute_query_keys(st, offs),
        st.n_active, window_r=32, table_cap=st.capacity,
    )
    assert_equal(start_t, start_j)
    assert_equal(unc_t, unc_j)
    assert int(unc_t.sum()) > 0


def test_window_plan_strided_forward_and_reverse():
    coords, feats = random_coo(3, n=512, grid=(16, 16, 16), c=4, density=0.1)
    sj, st = both(coords, feats, (16, 16, 16))
    from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
    from sparseeventid_tpu_torch.ops.rulebook import downsample_sites as tds

    skj, _ = jds(sj, (2, 2, 2), 512, with_dropped=True)
    skt, _ = tds(st, (2, 2, 2), 512, with_dropped=True)
    offs = kernel_offsets((2, 2, 2), centered=False)
    qj = jwc.compute_strided_query_keys(skj, sj.grid_shape, (2, 2, 2), offs)
    qt = tq.compute_strided_query_keys(skt, st.grid_shape, (2, 2, 2), offs)
    assert_equal(qt, qj)
    start_j, unc_j = _jax_plan(sj.keys(), qj, skj.n_active, 320, sj.capacity)
    start_t, unc_t = tk.window_plan(
        tq._padded_table(st.keys()), qt, skt.n_active, window_r=320,
        table_cap=st.capacity,
    )
    assert_equal(start_t, start_j)
    assert_equal(unc_t, unc_j)


def _conv_case(ksz, c, co, seed, strided=False, narrow=False):
    """(JAX tensor, port tensor, JAX-built plan, weights) of one
    window_conv_apply.  ``narrow``: the forced-overflow geometry with a
    32-row window, so some matches lie outside it and must not count."""
    if narrow:
        coords, feats, grid = line_coo(c=c)
    else:
        coords, feats = random_coo(seed, n=512, grid=(12, 12, 12), c=c,
                                   density=0.25, n_live=[400, 0])
        grid = (12, 12, 12)
    sj, st = both(coords, feats, grid)
    w = int_weights(seed + 1, (int(np.prod(ksz)), c, co))
    if strided:
        fwd, _ = jwe.build_strided_window_plans(sj, *_skel(sj), (2, 2, 2),
                                                interpret=True)
        plan = fwd
    else:
        r = 32 if narrow else 176 if len(kernel_offsets(ksz)) == 125 else 160
        plan = jwe.build_submanifold_window_plan(sj, ksz, interpret=True,
                                                 window_r=r)
    if narrow:
        assert int(np.asarray(plan.ov_valid).sum()) > 0
    return sj, st, plan, w


def _skel(sj):
    from sparseeventid_tpu.ops.rulebook import downsample_sites as jds

    skj, _ = jds(sj, (2, 2, 2), 512, with_dropped=True)
    return (skj,)


CONV_CASES = [
    ("k125_c1", (5, 5, 5), 1, 16, False, False, False),
    ("k27_c8", (3, 3, 3), 8, 16, False, False, False),
    ("k8_strided", (2, 2, 2), 8, 16, True, False, False),
    ("k27_kmap_mirror", (3, 3, 3), 8, 16, False, True, False),
    ("k27_out_of_window", (3, 3, 3), 4, 8, False, False, True),
]


@pytest.mark.parametrize("name,ksz,c,co,strided,mirror,narrow", CONV_CASES)
def test_window_conv_apply_bit_equal(name, ksz, c, co, strided, mirror, narrow):
    sj, st, plan, w = _conv_case(ksz, c, co, seed=5, strided=strided,
                                 narrow=narrow)
    kmap = None
    if mirror:
        kmap = tuple(int(x) for x in jwe._mirror_perm(plan.offsets))
    keys_in = sj.keys()
    want = jwc.window_conv_apply(
        keys_in, sj.feats, plan.qmeta, plan.start, jnp.asarray(w),
        plan.q_active, plan.dkeys, kmap=kmap, interpret=True,
        window_r=plan.window_r,
    )
    got = tk.window_conv_apply(
        st.keys(), st.feats, t(plan.qmeta), t(plan.start), torch.from_numpy(w),
        t(plan.q_active), plan.dkeys, kmap, window_r=plan.window_r,
    )
    assert_equal(got, want)
    assert float(np.abs(np.asarray(want)).sum()) > 0


def _overflow_inputs(c=4, co=8):
    """A plan with a non-empty overflow list (with holes) + integer data."""
    coords, feats, grid = line_coo(c=c)
    sj, st = both(coords, feats, grid)
    plan = jwe.build_submanifold_window_plan(sj, (3, 3, 3), overflow_cap=512,
                                             interpret=True, window_r=32)
    assert int(np.asarray(plan.ov_valid).sum()) > 0
    rng = np.random.default_rng(9)
    base = rng.integers(-4, 5, (1, sj.capacity, co)).astype(np.float32)
    w = int_weights(10, (27, c, co))
    return sj, st, plan, base, w


def test_overflow_apply_batched_bit_equal():
    sj, st, plan, base, w = _overflow_inputs()
    nb = jwc._ov_bound(plan.ov_valid)
    want = jws.overflow_apply_batched(
        jnp.asarray(base), sj.feats, jnp.asarray(w), plan.ov_src, plan.ov_dst,
        plan.ov_k, plan.ov_valid, nb, interpret=True,
    )
    nb_t = tk._ov_bound(t(plan.ov_valid))
    assert_equal(nb_t, nb)
    got = overflow_apply_batched(
        torch.from_numpy(base.copy()), st.feats, torch.from_numpy(w),
        t(plan.ov_src), t(plan.ov_dst), t(plan.ov_k), t(plan.ov_valid), nb_t,
    )
    assert_equal(got, want)


@pytest.mark.parametrize("c", [1, 4])
def test_overflow_apply_matches_xla_twin(c):
    sj, st, plan, base, w = _overflow_inputs(c=c)
    want = jwe._apply_overflow(
        jnp.asarray(base), sj.feats, jnp.asarray(w), plan.ov_src, plan.ov_dst,
        plan.ov_k, plan.ov_valid,
    )
    got = tk.overflow_apply(
        torch.from_numpy(base.copy()), st.feats, torch.from_numpy(w),
        t(plan.ov_src), t(plan.ov_dst), t(plan.ov_k), t(plan.ov_valid),
    )
    assert_equal(got, want)


def test_overflow_apply_empty_list_is_identity():
    base = torch.arange(24, dtype=torch.float32).reshape(1, 6, 4)
    z = torch.zeros((1, 5), dtype=torch.int32)
    got = tk.overflow_apply(
        base.clone(), torch.ones((1, 3, 2)), torch.ones((2, 2, 4)), z, z, z,
        torch.zeros((1, 5), dtype=torch.bool),
    )
    assert torch.equal(got, base)


def test_overflow_apply_in_order_rounding_with_duplicate_rows():
    """Duplicate dst rows accumulate with one rounding per entry, in list
    order, as the serial walk does (bf16: 256 + 1 + 1 stays 256 entry by
    entry, though 256 + 2 is representable)."""
    base = torch.full((1, 2, 1), 256.0, dtype=torch.bfloat16)
    table = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    w = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    idx = torch.zeros((1, 2), dtype=torch.int32)
    got = tk.overflow_apply(base, table, w, idx, idx, idx,
                            torch.ones((1, 2), dtype=torch.bool))
    assert got[0, 0, 0].item() == 256.0 and got[0, 1, 0].item() == 256.0


def test_wrappers_count_plain_calls_not_launches():
    sj, st, plan, base, w = _overflow_inputs()
    before = (tk.overflow_apply.launches, tk.overflow_apply_plain.calls)
    tk.overflow_apply(
        torch.from_numpy(base.copy()), st.feats, torch.from_numpy(w),
        t(plan.ov_src), t(plan.ov_dst), t(plan.ov_k), t(plan.ov_valid),
    )
    assert tk.overflow_apply.launches == before[0]
    assert tk.overflow_apply_plain.calls == before[1] + 1


@pytest.mark.parametrize("name,ksz,mirror,n_live,integer", [
    ("k27", (3, 3, 3), False, [400, 0], False),
    ("k27_kmap_mirror", (3, 3, 3), True, [400, 0], False),
    ("k27_dead_tile", (3, 3, 3), False, [100, 300], True),
    ("k9_plane", (1, 3, 3), False, [300, 200], False),
])
def test_window_gather_bit_equal(name, ksz, mirror, n_live, integer):
    """The gathered neighbour matrix equals the Pallas kernel's bit for bit
    on real-valued data (it copies rows): with and without ``kmap``, with an
    empty event (all its tiles dead) and with an event whose last tiles are
    dead (100 live rows of 512)."""
    coords, feats = random_coo(11, n=512, grid=(12, 12, 12), c=8, density=0.25,
                               n_live=n_live, integer=integer)
    sj, st = both(coords, feats, (12, 12, 12))
    plan = jwe.build_submanifold_window_plan(sj, ksz, interpret=True,
                                             window_r=160)
    kmap = None
    if mirror:
        kmap = tuple(int(x) for x in jwe._mirror_perm(plan.offsets))
    want = jwc.window_gather(
        sj.keys(), sj.feats, plan.qmeta, plan.start, plan.q_active,
        plan.dkeys, kmap=kmap, interpret=True, window_r=plan.window_r,
    )
    before = tk.window_gather_plain.calls
    got = tk.window_gather(
        st.keys(), st.feats, t(plan.qmeta), t(plan.start), t(plan.q_active),
        plan.dkeys, kmap, window_r=plan.window_r,
    )
    assert tk.window_gather_plain.calls == before + 1
    assert got.shape == (2, 512, len(plan.offsets) * 8)
    assert_equal(got, want)
    assert float(got.abs().sum()) > 0
    dead = [(b, -(-n // 128) * 128) for b, n in enumerate(n_live)]
    for b, first_dead_row in dead:
        assert float(got[b, first_dead_row:].abs().sum()) == 0


def test_window_gather_leaves_out_of_window_pairs():
    """With a narrow window the gathered set is the conv's in-window set:
    contracting it with W equals ``window_conv_apply``, and differs from the
    full rulebook's conv by exactly the overflow list's pairs."""
    coords, feats, grid = line_coo(c=4)
    sj, st = both(coords, feats, grid)
    plan = jwe.build_submanifold_window_plan(sj, (3, 3, 3), overflow_cap=512,
                                             interpret=True, window_r=32)
    assert int(np.asarray(plan.ov_valid).sum()) > 0
    args = (st.keys(), st.feats, t(plan.qmeta), t(plan.start))
    g = tk.window_gather(*args, t(plan.q_active), plan.dkeys,
                         window_r=plan.window_r)
    assert_equal(g, jwc.window_gather(
        sj.keys(), sj.feats, plan.qmeta, plan.start, plan.q_active,
        plan.dkeys, interpret=True, window_r=plan.window_r))
    w = torch.from_numpy(int_weights(4, (27, 4, 8)))
    conv = tk.window_conv_apply(*args, w, t(plan.q_active), plan.dkeys,
                                window_r=plan.window_r)
    assert torch.equal(torch.matmul(g, w.reshape(27 * 4, 8)), conv)
