"""The window kernels' plain versions in the PyTorch port against the JAX
Pallas kernels (interpret mode) on the same integer-valued inputs: every
result must be bit-equal.  On CPU tensors the port's wrappers run their
plain versions; the CUDA kernels are held against these on the card by
chip_smoke.py."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, line_coo, random_coo, t

from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.pallas import window_sidecar as jws
from sparseeventid_tpu.ops.rulebook import kernel_offsets
from sparseeventid_tpu_torch import ops as tops
from sparseeventid_tpu_torch.ops import engine as teng
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import engine as twe
from sparseeventid_tpu_torch.ops.window import kernels as tk
from sparseeventid_tpu_torch.ops.window import query as tq
from sparseeventid_tpu_torch.ops.window.sidecar import overflow_apply_batched

# (name, kernel size, window rows): the initial 5^3 conv, a series conv, a
# window narrow enough to push many pairs out of it, and the 2D kernels,
# whose K (9, 25) is not a multiple of the 8 offsets a kernel block takes
# at least
PLAN_CASES = [("k125", (5, 5, 5), 176), ("k27", (3, 3, 3), 160),
              ("k27_narrow", (3, 3, 3), 32), ("k9_2d", (1, 3, 3), 160),
              ("k25_2d", (1, 5, 5), 176)]


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


def _conv_case(ksz, c, co, seed, strided=False, narrow=False, n=512,
               n_live=(400, 0)):
    """(JAX tensor, port tensor, JAX-built plan, weights) of one
    window_conv_apply.  ``narrow``: the forced-overflow geometry with a
    32-row window, so some matches lie outside it and must not count."""
    if narrow:
        coords, feats, grid = line_coo(c=c)
    else:
        coords, feats = random_coo(seed, n=n, grid=(12, 12, 12), c=c,
                                   density=0.25, n_live=list(n_live))
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


def _dense_tile_case(ksz, c, co, seed):
    """A fully dense block: the table is every site of a 3 x 3 x 130 rod,
    the queries its 128 interior sites (1, 1, 1..128), one tile whose every
    query has all 27 neighbours, each inside the tile's plan window (a
    neighbour offset shifts the 128 rows by a constant).  -> the
    _conv_case tuple, the plan built from the JAX functions."""
    grid = (3, 3, 130)
    cube = np.stack(np.meshgrid(*[np.arange(g) for g in grid], indexing="ij"),
                    -1).reshape(1, -1, 3).astype(np.int32)
    rng = np.random.default_rng(seed)
    feats = rng.integers(-3, 4, (1, cube.shape[1], c)).astype(np.float32)
    inner = np.stack([np.ones(128), np.ones(128), np.arange(1, 129)],
                     -1).reshape(1, -1, 3).astype(np.int32)
    sj, st = both(cube, feats, grid)
    qj, _ = both(inner, np.zeros((1, 128, 1), np.float32), grid)
    offs = kernel_offsets(ksz, centered=True)
    r = 160
    start, unc = _jax_plan(sj.keys(), jwc.compute_query_keys(qj, offs),
                           qj.n_active, r, sj.capacity)
    assert int(np.asarray(unc).sum()) == 0  # every pair inside its window
    plan = types.SimpleNamespace(
        qmeta=jwc.compute_query_meta(qj, offs), start=start,
        q_active=qj.n_active, dkeys=jwc.key_deltas(grid, offs),
        offsets=tuple(map(tuple, offs.tolist())), window_r=r)
    return sj, st, plan, int_weights(seed + 1, (len(offs), c, co))


# (name, kernel size, C, CO, strided, mirrored kmap, narrow window).
# C and CO not multiples of 64 (24 -> 40, 96 -> 160) are the ragged edges
# of the kernel's 64-deep chunks; k27_q_bound and k27_dense_tile take the
# inputs of CONV_Q_BOUND and _dense_tile_case.
CONV_CASES = [
    ("k125_c1", (5, 5, 5), 1, 16, False, False, False),
    ("k27_c8", (3, 3, 3), 8, 16, False, False, False),
    ("k8_strided", (2, 2, 2), 8, 16, True, False, False),
    ("k27_kmap_mirror", (3, 3, 3), 8, 16, False, True, False),
    ("k27_out_of_window", (3, 3, 3), 4, 8, False, False, True),
    ("k27_c24_co40", (3, 3, 3), 24, 40, False, False, False),
    ("k27_c96_co160", (3, 3, 3), 96, 160, False, False, False),
    ("k27_q_bound", (3, 3, 3), 8, 16, False, False, False),
    ("k27_dense_tile", (3, 3, 3), 8, 16, False, False, False),
]
# a static row bound below M = 1024 rows, a multiple of 512 as the engine's
# (ops.engine.query_bound), with live rows on both sides of it
CONV_Q_BOUND = {"k27_q_bound": (512, dict(n=1024, n_live=(900, 300)))}


@pytest.mark.parametrize("name,ksz,c,co,strided,mirror,narrow", CONV_CASES)
def test_window_conv_apply_bit_equal(name, ksz, c, co, strided, mirror, narrow):
    q_bound, rows = CONV_Q_BOUND.get(name, (None, {}))
    if name == "k27_dense_tile":
        sj, st, plan, w = _dense_tile_case(ksz, c, co, seed=5)
    else:
        sj, st, plan, w = _conv_case(ksz, c, co, seed=5, strided=strided,
                                     narrow=narrow, **rows)
    kmap = None
    if mirror:
        kmap = tuple(int(x) for x in jwe._mirror_perm(plan.offsets))

    def run(bound):
        want = jwc.window_conv_apply(
            sj.keys(), sj.feats, plan.qmeta, plan.start, jnp.asarray(w),
            plan.q_active, plan.dkeys, kmap=kmap, interpret=True,
            window_r=plan.window_r, q_bound=bound,
        )
        got = tk.window_conv_apply(
            st.keys(), st.feats, t(plan.qmeta), t(plan.start),
            torch.from_numpy(w), t(plan.q_active), plan.dkeys, kmap,
            window_r=plan.window_r, q_bound=bound,
        )
        assert_equal(got, want)
        return np.asarray(want)

    want = run(q_bound)
    assert float(np.abs(want).sum()) > 0
    if q_bound is not None:  # the rows past the bound are 0, and not by chance
        assert float(np.abs(want[:, q_bound:]).sum()) == 0
        assert float(np.abs(run(None)[:, q_bound:]).sum()) > 0
    if name == "k27_dense_tile":  # every query matches at every offset
        for _, found, _ in tk._matched_rows(
                st.keys(), t(plan.qmeta), t(plan.start), t(plan.q_active),
                plan.dkeys, None, plan.window_r, None):
            assert bool(found.all())


@pytest.mark.parametrize("m,k,c,co,want", [
    (50176, 27, 32, 32, 1),   # level 0: 14 steps a tile
    (25088, 27, 64, 64, 1),   # level 1: the grid is full
    (12800, 27, 96, 96, 2),   # level 2: 41 steps
    (6656, 27, 128, 128, 4),  # level 3: 54 steps
    (3584, 27, 160, 160, 4),  # level 4: 68 steps
    (2048, 27, 192, 192, 4),  # level 5: 81 steps
    (2048, 9, 192, 192, 2),   # dune2d level 5: 27 steps
    (4096, 9, 160, 160, 1),   # dune2d level 4: 23 steps
    (2048, 8, 160, 192, 1),   # a downsample into level 5: 20 steps
    (50176, 125, 1, 32, 1),   # the C == 1 route takes the tile whole
])
def test_conv_groups_spread_the_deep_levels(m, k, c, co, want):
    """The wrapper's choice of blocks (a cluster) that share a tile's
    offsets in window_conv_apply (8 events, 132 SMs): a power of two up to
    8, at least 13 of the tile's 64-deep steps a block, at most 13 blocks
    an SM."""
    g = tk._conv_groups(132, 8, m, k, c, co)
    assert g == want
    assert g in (1, 2, 4, 8)
    assert g == 1 or (-(-k * c // 64) >= 13 * g
                      and 8 * -(-m // 128) * -(-co // 192) * g <= 13 * 132)


@pytest.mark.parametrize("b,n_tiles,k,want", [
    (8, 392, 27, 27),   # level 0: one group of all offsets
    (8, 392, 125, 32),  # the initial 5^3 conv: groups of 32
    (8, 16, 27, 8),     # level 5: 128 tiles spread over 4 groups of 8
    (8, 16, 9, 8),      # dune2d level 5: K = 9 -> 8 + 1
    (1, 4, 4, 4),       # fewer offsets than warps
])
def test_plan_group_fills_the_card(b, n_tiles, k, want):
    """The wrapper's choice of offsets a window_plan block takes (132 SMs):
    at most 32, and halved while the grid has under 4 blocks an SM, down to
    one offset a warp."""
    g = tk._plan_group(132, b, n_tiles, k)
    assert g == want
    blocks = -(-k // g) * n_tiles * b
    assert blocks >= 4 * 132 or g == min(k, 8)


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


def _port_plan(builder):
    """(plan, K) from one overflow-list builder of the port, with windows
    narrow enough (32 rows) to put pairs on its list."""
    narrow = tq.WindowTuning(window_r=32, window_r_strided=32)
    if builder == "submanifold_3d":
        coords, feats, grid = line_coo()
        st = tops.build_sparse_tensor(torch.from_numpy(coords),
                                      torch.from_numpy(feats), grid)
        return twe.build_submanifold_window_plan(st, (3, 3, 3), 32, 512), 27
    if builder.startswith("multiplane_2d"):
        ksz = (1, 3, 3) if builder.endswith("1x3x3") else (3, 3, 3)
        coords, feats = random_coo(4, n=1024, grid=(3, 32, 32), c=4,
                                   density=0.15)
        st = tops.build_sparse_tensor(torch.from_numpy(coords),
                                      torch.from_numpy(feats), (3, 32, 32))
        plan = twe.build_submanifold_window_plan(st, ksz, 32, 4096)
        return plan, int(np.prod(ksz))
    if builder.startswith("strided"):
        grid, stride = (16, 16, 16), (2, 2, 2)
    else:  # the deconv's plans, on the plane grid
        grid, stride = (3, 32, 32), (1, 2, 2)
    coords, feats = random_coo(3, n=512, grid=grid, c=4, density=0.1)
    fine = tops.build_sparse_tensor(torch.from_numpy(coords),
                                    torch.from_numpy(feats), grid)
    coarse = trb.downsample_sites(fine, stride, 512)
    if builder.startswith("strided"):
        fwd, rev = twe.build_strided_window_plans(fine, coarse, stride, 512,
                                                  tuning=narrow)
    else:
        fwd, rev = teng.build_upsample_plan(coarse, fine, stride,
                                            backend=teng.WINDOW, tuning=narrow)
    return (fwd if builder.endswith("forward") else rev), int(np.prod(stride))


@pytest.mark.parametrize("builder", [
    "submanifold_3d", "strided_forward", "strided_reverse", "upsample_forward",
    "upsample_reverse", "multiplane_2d_1x3x3", "multiplane_2d_3x3x3",
])
def test_overflow_lists_keep_dst_ordered(builder):
    """The sidecar kernel gives each output row to one block, so it needs
    ``dst`` non-decreasing over the walked prefix, holes included: every
    list builder of the port keeps it, and a row holds at most K entries,
    all contiguous."""
    plan, k = _port_plan(builder)
    nb = tk._ov_bound(plan.ov_valid)
    assert int(plan.ov_valid.sum()) > 0 and int(plan.ov_dropped.sum()) == 0
    assert tk.overflow_dst_ordered(plan.ov_dst, nb)
    for b in range(plan.ov_dst.shape[0]):
        walked = plan.ov_dst[b, : int(nb[b])]
        _, runs = torch.unique_consecutive(walked, return_counts=True)
        assert runs.numel() == torch.unique(walked).numel()
        assert int(runs.max()) <= k


def test_overflow_dst_ordered_reads_only_the_walked_prefix():
    dst = torch.tensor([[0, 1, 1, 5, 2, 0], [3, 2, 9, 9, 9, 9]])
    assert tk.overflow_dst_ordered(dst, torch.tensor([4, 1]))
    assert not tk.overflow_dst_ordered(dst, torch.tensor([5, 1]))
    assert not tk.overflow_dst_ordered(dst, torch.tensor([4, 2]))


def _handmade_list(case, k, m, n, s, seed=0):
    """(src, dst, kk, valid) of two events, rows in ascending ``dst`` with
    1..K entries each (distinct offsets).  ``row_of_k``: one row takes all K
    offsets; ``holes``: 30% of the prefix is invalid, ``dst`` kept in order;
    ``empty_event``: event 0 has no valid entry (n_bound 0);
    ``garbage_past_bound``: nothing special, as in every case the entries
    past the prefix are invalid with indices out of every range."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-9, 3 * n, (2, s)).astype(np.int32)
    dst = rng.integers(-9, 3 * m, (2, s)).astype(np.int32)
    kk = rng.integers(-3, 2 * k, (2, s)).astype(np.int32)
    valid = np.zeros((2, s), bool)
    for e in range(2):
        if case == "empty_event" and e == 0:
            continue
        rows = np.sort(rng.choice(m, 6, replace=False))
        runs = rng.integers(1, k + 1, 6)
        if case == "row_of_k":
            runs[1] = k
        entries = [(r, kx) for r, run in zip(rows, runs)
                   for kx in rng.permutation(k)[:run]][: s - 4]
        p = len(entries)
        dst[e, :p] = [r for r, _ in entries]
        kk[e, :p] = [kx for _, kx in entries]
        src[e, :p] = rng.integers(0, n, p)
        valid[e, :p] = True
        if case == "holes":
            valid[e, : p - 1] &= rng.random(p - 1) > 0.3
    return src, dst, kk, valid


@pytest.mark.parametrize("entry", ["serial", "batched"])
@pytest.mark.parametrize(
    "case", ["row_of_k", "holes", "empty_event", "garbage_past_bound"])
def test_overflow_apply_plain_on_handmade_lists(case, entry):
    """The sidecar's plain version against JAX's on lists the engine rarely
    builds, integer data, bit for bit.  The serial entry (C == 1) against
    its XLA twin ``window_engine._apply_overflow`` (the Pallas kernel has no
    interpret mode), the batched one (C == 8) against the Pallas kernel in
    interpret mode."""
    k, m, n, s, co = 27, 40, 30, 128, 8
    c = 1 if entry == "serial" else 8
    rng = np.random.default_rng(1)
    base = rng.integers(-4, 5, (2, m, co)).astype(np.float32)
    table = rng.integers(-3, 4, (2, n, c)).astype(np.float32)
    w = int_weights(2, (k, c, co))
    src, dst, kk, valid = _handmade_list(case, k, m, n, s)
    nb = jwc._ov_bound(jnp.asarray(valid))
    if entry == "serial":
        want = jwe._apply_overflow(jnp.asarray(base), jnp.asarray(table),
                                   jnp.asarray(w), src, dst, kk, valid)
    else:
        want = jws.overflow_apply_batched(
            jnp.asarray(base), jnp.asarray(table), jnp.asarray(w), src, dst,
            kk, valid, nb, interpret=True)
    nb_t = tk._ov_bound(torch.from_numpy(valid))
    assert_equal(nb_t, nb)
    assert tk.overflow_dst_ordered(torch.from_numpy(dst), nb_t)
    if case == "empty_event":
        assert int(nb_t[0]) == 0
    wrapper = tk.overflow_apply if entry == "serial" else overflow_apply_batched
    got = wrapper(torch.from_numpy(base.copy()), torch.from_numpy(table),
                  torch.from_numpy(w), torch.from_numpy(src),
                  torch.from_numpy(dst), torch.from_numpy(kk),
                  torch.from_numpy(valid), nb_t)
    assert_equal(got, want)
    assert not np.array_equal(np.asarray(want)[1], base[1])


# (K, C, CO, piece (offsets, channels), parts) of every dW sidecar list of
# both recipes: the initial convs, the series convs, the downsamples
OV_SHAPES = [
    ("initial 5^3", 125, 1, 32, (125, 1), 256),
    ("2d initial", 25, 1, 32, (25, 1), 256),
    ("L0 series", 27, 32, 32, (4, 32), 37),
    ("L2 series", 27, 96, 96, (1, 32), 4),
    ("L5 series", 27, 192, 192, (1, 16), 1),
    ("2d L0 series", 9, 32, 32, (4, 32), 88),
    ("2d L5 series", 9, 192, 192, (1, 16), 3),
    ("L0 downsample", 8, 32, 64, (2, 32), 64),
    ("L1 downsample", 8, 64, 96, (1, 32), 17),
    ("L4 downsample", 8, 160, 192, (1, 16), 4),
]


@pytest.mark.parametrize("label,k,c,co,piece,parts", OV_SHAPES)
def test_overflow_dw_geometry(label, k, c, co, piece, parts):
    """The dW sidecar's piece of dw (whole [C, CO] panels of as many offsets
    as fit 4096 floats, CO padded to 4, else one offset with the channels
    cut about evenly in multiples of 8) and its parts on 132 SMs: about two
    blocks an SM, at most 256, and at most 2^20 partial floats for the
    ordered sum (a 4 MB scratch).  They depend on the shape only, never on
    the list."""
    assert tk._ov_dw_piece(k, c, co) == piece
    kr, cr = piece
    assert kr * cr * -(-co // 4) * 4 <= 4096 and 1 <= kr <= k and 1 <= cr <= c
    assert (kr == 1 and cr % 8 == 0) or cr == c
    p = tk._ov_dw_parts(132, k, c, co)
    assert p == parts
    assert 1 <= p <= 256 and p * k * c * co <= 1 << 20


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


@pytest.mark.parametrize("name,deconv,c", [
    ("k27_c12", False, 12),
    ("k8_deconv_c12", True, 12),
    ("k8_deconv_c16", True, 16),
])
def test_window_gather_real_fp32_widths(name, deconv, c):
    """Real-valued fp32 data at row widths the kernel copies in 16-byte units
    (C = 16: 64 bytes) and value by value (C = 12: 48 bytes in fp32, 24 in
    bf16), over a series plan and over the deconv's reverse plan (K = 8,
    table: the coarse sites, queries: the fine ones) with one event empty
    (q_active = 0, all its tiles dead): bit-equal to the Pallas kernel."""
    from sparseeventid_tpu.ops.rulebook import downsample_sites as jds

    coords, feats = random_coo(17, n=512, grid=(12, 12, 12), c=c, density=0.25,
                               n_live=[300, 0], integer=False)
    sj, st = both(coords, feats, (12, 12, 12))
    if deconv:
        skj, _ = jds(sj, (2, 2, 2), 512, with_dropped=True)
        _, plan = jwe.build_strided_window_plans(sj, skj, (2, 2, 2),
                                                 interpret=True)
        assert len(plan.dkeys) == 8
        rng = np.random.default_rng(18)
        table = rng.standard_normal((2, 512, c)).astype(np.float32)
        table *= np.asarray(skj.row_mask())[..., None]
        keys_j, feats_j = skj.keys(), jnp.asarray(table)
        keys_t, feats_t = t(keys_j), torch.from_numpy(table)
    else:
        plan = jwe.build_submanifold_window_plan(sj, (3, 3, 3), interpret=True,
                                                 window_r=160)
        keys_j, feats_j, keys_t, feats_t = sj.keys(), sj.feats, st.keys(), st.feats
    assert int(np.asarray(plan.q_active)[1]) == 0
    want = jwc.window_gather(keys_j, feats_j, plan.qmeta, plan.start,
                             plan.q_active, plan.dkeys, interpret=True,
                             window_r=plan.window_r)
    got = tk.window_gather(keys_t, feats_t, t(plan.qmeta), t(plan.start),
                           t(plan.q_active), plan.dkeys, window_r=plan.window_r)
    assert got.dtype == torch.float32
    assert_equal(got, want)
    assert float(got[0].abs().sum()) > 0
    assert float(got[1].abs().sum()) == 0


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
