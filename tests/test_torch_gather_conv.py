"""The port's gather-GEMM submanifold conv (plain version on the CPU)
against the JAX package's Pallas kernel in interpret mode and its
``jax.grad``: exact on integer-valued data, ``rtol=1e-5`` on real-valued
float32 data (the kernel sums per offset, the TPU kernel in one dot)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, random_coo, t

from sparseeventid_tpu import ops as jops
from sparseeventid_tpu.ops.pallas import gather_conv as jgc
from sparseeventid_tpu_torch.ops import conv as tconv
from sparseeventid_tpu_torch.ops import gather_conv as tgc
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import kernels as tk

# (name, grid, kernel): the 3D series kernel and the 2D plane kernel
GEOMETRIES = [("3d", (12, 12, 12), (3, 3, 3)), ("plane", (3, 12, 12), (1, 3, 3))]


def _case(grid, ksz, integer, c=8, co=16, seed=21):
    coords, feats = random_coo(seed, b=2, n=128, grid=grid, c=c, density=0.15,
                               integer=integer, n_live=[90, 40])
    sj, st = both(coords, feats, grid)
    k = int(np.prod(ksz))
    rng = np.random.default_rng(seed + 1)
    if integer:
        w = int_weights(seed + 2, (k, c, co))
        bias = rng.integers(-2, 3, co).astype(np.float32)
    else:
        w = (rng.standard_normal((k, c, co)) * 0.2).astype(np.float32)
        bias = rng.standard_normal(co).astype(np.float32)
    return sj, st, w, bias


def _check(got, want, integer):
    if integer:
        assert_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_mirror_permutation_and_miss_encoding():
    offs = tuple(map(tuple, trb.kernel_offsets((1, 3, 3)).tolist()))
    perm = tgc.mirror_permutation(offs)
    np.testing.assert_array_equal(perm, jgc.mirror_permutation(offs))
    np.testing.assert_array_equal(np.asarray(offs)[perm], -np.asarray(offs))
    sj, st, _, _ = _case((12, 12, 12), (3, 3, 3), True)
    rbj = jops.build_submanifold_rulebook(sj, (3, 3, 3))
    rbt = trb.build_submanifold_rulebook(st, (3, 3, 3))
    assert_equal(tgc._encode_miss(rbt, st.capacity),
                 jgc._encode_miss(rbj, sj.capacity))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name,grid,ksz", GEOMETRIES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_forward_matches_pallas(name, grid, ksz, integer, with_bias):
    sj, st, w, bias = _case(grid, ksz, integer)
    rbj = jops.build_submanifold_rulebook(sj, ksz)
    want = jgc.pallas_submanifold_conv(
        sj, rbj, jnp.asarray(w), jnp.asarray(bias) if with_bias else None,
        interpret=True)
    rbt = trb.build_submanifold_rulebook(st, ksz)
    before = (tgc.gather_conv.launches, tgc.gather_conv_plain.calls)
    with torch.no_grad():
        got = tgc.gather_submanifold_conv(
            st, rbt, torch.from_numpy(w),
            torch.from_numpy(bias) if with_bias else None)
    assert (tgc.gather_conv.launches, tgc.gather_conv_plain.calls) == (
        before[0], before[1] + 1)
    _check(got.feats, want.feats, integer)
    assert float(got.feats.abs().sum()) > 0
    # and the port's own plain backend
    ref = tconv.submanifold_conv(st, rbt, torch.from_numpy(w),
                                 torch.from_numpy(bias) if with_bias else None)
    _check(got.feats, ref.feats.numpy(), integer)


def test_single_event_entry_matches_pallas():
    sj, st, w, _ = _case((12, 12, 12), (3, 3, 3), True)
    rbj = jops.build_submanifold_rulebook(sj, (3, 3, 3))
    idx = jgc._encode_miss(rbj, sj.capacity)
    want = jgc.gather_conv_single(sj.feats[0], idx[0], jnp.asarray(w),
                                  interpret=True)
    got = tgc.gather_conv_single(st.feats[0], t(idx)[0], torch.from_numpy(w))
    assert_equal(got, want)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name,grid,ksz", GEOMETRIES)
def test_gradients_match_pallas(name, grid, ksz, integer):
    """dX (the same kernel on gy, index columns mirrored, weights
    transposed) and dW against jax.grad through the Pallas custom VJP, and
    against the port's plain backend under autograd."""
    sj, st, w, _ = _case(grid, ksz, integer)
    rbj = jops.build_submanifold_rulebook(sj, ksz)
    rbt = trb.build_submanifold_rulebook(st, ksz)
    rng = np.random.default_rng(5)
    gy = (rng.integers(-2, 3, (2, 128, 16)) if integer
          else rng.standard_normal((2, 128, 16))).astype(np.float32)

    def loss(wj, fj):
        out = jgc.pallas_submanifold_conv(sj.with_feats(fj), rbj, wj,
                                          interpret=True).feats
        return jnp.sum(out * jnp.asarray(gy))

    gw_j, gx_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), sj.feats)

    def grads(conv):
        x = st.feats.clone().requires_grad_(True)
        wt = torch.from_numpy(w).clone().requires_grad_(True)
        conv(st.with_feats(x), rbt, wt).feats.backward(torch.from_numpy(gy))
        return x.grad, wt.grad

    gx, gw = grads(tgc.gather_submanifold_conv)
    _check(gx, gx_j, integer)
    _check(gw, gw_j, integer)
    assert float(gx.abs().sum()) > 0 and float(gw.abs().sum()) > 0
    rx, rw = grads(tconv.submanifold_conv)
    # the plain backend's output is masked at padding rows, the gather
    # conv's is not (no bias): mask gy's dead rows out of the comparison
    live = st.row_mask()[..., None]
    gy_live = torch.from_numpy(gy) * live
    x = st.feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).clone().requires_grad_(True)
    tgc.gather_submanifold_conv(st.with_feats(x), rbt, wt).feats.backward(gy_live)
    _check(x.grad, rx.numpy(), integer)
    _check(wt.grad, rw.numpy(), integer)


def test_dx_with_both_permuted_is_wrong(monkeypatch):
    """Permuting the weights as well as the index columns cancels the
    mirror: it equals no permutation at all, and dX changes."""
    sj, st, w, _ = _case((12, 12, 12), (3, 3, 3), True)
    rbt = trb.build_submanifold_rulebook(st, (3, 3, 3))
    gy = torch.from_numpy(int_weights(9, (2, 128, 16)))

    def dx():
        x = st.feats.clone().requires_grad_(True)
        tgc.gather_submanifold_conv(
            st.with_feats(x), rbt, torch.from_numpy(w)).feats.backward(gy)
        return x.grad

    sound = dx()
    monkeypatch.setattr(tgc, "mirror_permutation",
                        lambda offsets: np.arange(len(offsets)))
    assert not torch.equal(dx(), sound)


# (name, N table rows, M output rows, K, C, CO): the edges of the bf16
# kernel's 128-row tiles, 64-deep chunks and 192-column slabs
EDGE_CASES = [
    ("m_not_tile_multiple", 300, 200, 9, 16, 24),
    ("c48_co40_partial_depth", 200, 192, 27, 48, 40),
    ("c8_k27_offsets_share_a_chunk", 160, 130, 27, 8, 16),
    ("co200_two_slabs", 150, 130, 8, 16, 200),
]


@pytest.mark.parametrize("name,n,m,k,c,co", EDGE_CASES)
def test_gather_conv_edges_match_pallas(name, n, m, k, c, co):
    """The plain version against gather_conv_single in interpret mode, per
    event, on integer-valued data: exact.  Event 0's indices miss at about
    a third of its entries (miss = N), event 1's all miss (its output is
    0)."""
    rng = np.random.default_rng(len(name))
    feats = rng.integers(-3, 4, (2, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (2, m, k)).astype(np.int32)
    idx[0][rng.random((m, k)) < 0.3] = n
    idx[1] = n
    w = int_weights(3, (k, c, co))
    got = tgc.gather_conv(torch.from_numpy(feats), torch.from_numpy(idx),
                          torch.from_numpy(w))
    assert got.shape == (2, m, co)
    for b in range(2):
        want = jgc.gather_conv_single(jnp.asarray(feats[b]), jnp.asarray(idx[b]),
                                      jnp.asarray(w), interpret=True)
        assert_equal(got[b], want)
    assert float(got[0].abs().sum()) > 0
    assert float(got[1].abs().sum()) == 0


@pytest.mark.parametrize("miss", [-1, 2 * 150, -(2**31)])
def test_gather_conv_any_index_outside_the_table_misses(miss):
    """-1, 2N and INT_MIN give the output of the rulebook's encoding N, which
    the Pallas kernel takes."""
    n, m, k, c, co = 150, 140, 27, 8, 16
    rng = np.random.default_rng(7)
    feats = rng.integers(-3, 4, (1, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (1, m, k)).astype(np.int32)
    at = rng.random((1, m, k)) < 0.4
    w = torch.from_numpy(int_weights(4, (k, c, co)))
    x = torch.from_numpy(feats)
    idx_n = np.where(at, n, idx).astype(np.int32)
    idx_miss = np.where(at, miss, idx).astype(np.int32)
    with_n = tgc.gather_conv(x, torch.from_numpy(idx_n), w)
    other = tgc.gather_conv(x, torch.from_numpy(idx_miss), w)
    assert torch.equal(other, with_n)
    want = jgc.gather_conv_single(jnp.asarray(feats[0]), jnp.asarray(idx_n[0]),
                                  jnp.asarray(w.numpy()), interpret=True)
    assert_equal(with_n[0], want)


@pytest.mark.parametrize("m,c,co,want", [
    (50176, 32, 32, 1),    # level 0: 14 of the 64-deep steps a tile
    (25088, 64, 64, 1),    # level 1: 27 steps
    (12800, 96, 96, 2),    # level 2: 41 steps
    (6656, 128, 128, 2),   # level 3: 54 steps (the window conv takes 4)
    (3584, 160, 160, 2),   # level 4: 68 steps (the window conv takes 4)
    (2048, 192, 192, 4),   # level 5: 81 steps, 128 tiles
])
def test_gather_groups_at_the_dune3d_levels(m, c, co, want):
    """The wrapper's cluster size for the bf16 route at the dune3d levels
    (8 events, 132 SMs): a power of two up to 8, at least 20 of the tile's
    64-deep steps a block, at most 13 blocks an SM."""
    g = tgc.gather_groups(132, 8, m, 27, c, co)
    assert g == want
    assert g in (1, 2, 4, 8)
    assert g == 1 or (-(-27 * c // 64) >= 20 * g
                      and 8 * -(-m // 128) * -(-co // 192) * g <= 13 * 132)
    assert g <= tk._conv_groups(132, 8, m, 27, c, co)

