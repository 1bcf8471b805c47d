"""The port's sparse tensor, rulebook and plain conv ops against the JAX
package's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, random_coo

from sparseeventid_tpu import ops as jops
from sparseeventid_tpu.io import SyntheticDataset as JDataset
from sparseeventid_tpu.io import SyntheticEventConfig as JEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.ops.rulebook import build_downsample_rulebook as jdr
from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
from sparseeventid_tpu_torch import ops as tops
from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch


def test_synthetic_generator_is_the_same():
    kw = dict(image_size=(32, 32, 32), max_voxels=512, mean_tracks=6.0)
    a = JDataset(4, JEventConfig(**kw), seed=7).batch([0, 1, 2, 3])
    b = SyntheticDataset(4, SyntheticEventConfig(**kw), seed=7).batch([0, 1, 2, 3])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("capacity", [None, 1024])
def test_build_sparse_tensor_matches_jax(capacity):
    ds = SyntheticDataset(
        2, SyntheticEventConfig(image_size=(32, 32, 32), max_voxels=512), seed=1
    )
    image = ds.batch([0, 1])["image"]
    sj = jbatch(image, (32, 32, 32), capacity=capacity)
    st = tbatch(image, (32, 32, 32), capacity=capacity)
    assert_equal(st.n_active, sj.n_active)
    assert_equal(st.coords, sj.coords)
    assert_equal(st.feats, sj.feats)
    assert_equal(st.keys(), sj.keys())
    keys = st.keys()
    for b in range(2):
        live = keys[b, : int(st.n_active[b])]
        assert bool((live[1:] > live[:-1]).all())  # sorted, unique
    assert_equal(tops.unlinearize(keys, st.grid_shape), sj.coords)


def test_downsample_sites_and_dropped_match_jax():
    coords, feats = random_coo(2, n=512, grid=(16, 16, 16), c=2, density=0.1)
    sj, st = both(coords, feats, (16, 16, 16))
    for cap in (512, 64):  # 64 truncates: dropped counts the lost sites
        skj, dj = jds(sj, (2, 2, 2), cap, with_dropped=True)
        skt, dt = tops.downsample_sites(st, (2, 2, 2), cap, with_dropped=True)
        assert_equal(skt.coords, skj.coords)
        assert_equal(skt.n_active, skj.n_active)
        assert_equal(dt, dj)
        assert skt.grid_shape == skj.grid_shape
    assert int(dt.sum()) > 0


@pytest.mark.parametrize("ksz", [(3, 3, 3), (5, 5, 5)])
def test_submanifold_conv_bit_equal(ksz):
    coords, feats = random_coo(3, n=512, grid=(12, 12, 12), c=4, density=0.2)
    sj, st = both(coords, feats, (12, 12, 12))
    k = int(np.prod(ksz))
    w = int_weights(4, (k, 4, 8))
    bias = np.arange(8, dtype=np.float32) - 4
    rj = jops.build_submanifold_rulebook(sj, ksz)
    rt = tops.build_submanifold_rulebook(st, ksz)
    assert_equal(rt.neighbor_idx, rj.neighbor_idx)
    assert_equal(rt.hit, rj.hit)
    want = jops.submanifold_conv(sj, rj, jnp.asarray(w), jnp.asarray(bias))
    got = tops.submanifold_conv(st, rt, torch.from_numpy(w), torch.from_numpy(bias))
    assert torch.equal(got.feats, torch.from_numpy(np.asarray(want.feats)))


def test_strided_conv_bit_equal():
    coords, feats = random_coo(5, n=512, grid=(16, 16, 16), c=4, density=0.1)
    sj, st = both(coords, feats, (16, 16, 16))
    skj = jds(sj, (2, 2, 2), 512)
    skt = tops.downsample_sites(st, (2, 2, 2), 512)
    w = int_weights(6, (8, 4, 8))
    want = jops.strided_conv(sj, skj, jdr(sj, skj, (2, 2, 2)), jnp.asarray(w))
    got = tops.strided_conv(
        st, skt, tops.build_downsample_rulebook(st, skt, (2, 2, 2)),
        torch.from_numpy(w),
    )
    assert torch.equal(got.feats, torch.from_numpy(np.asarray(want.feats)))


def test_masked_norm_and_pool_match_jax():
    coords, feats = random_coo(6, n=256, grid=(8, 8, 8), c=4, density=0.2,
                               integer=False)
    sj, st = both(coords, feats, (8, 8, 8))
    mj, vj = jops.masked_batch_stats(sj.feats, sj.row_mask())
    mt, vt = tops.masked_batch_stats(st.feats, st.row_mask())
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)
    scale, off = np.float32([1.0, 2.0, 0.5, -1.0]), np.float32([0, 1, -1, 2])
    want = jops.apply_norm(sj.feats, sj.row_mask(), mj, vj, jnp.asarray(scale),
                           jnp.asarray(off))
    got = tops.apply_norm(st.feats, st.row_mask(), mt, vt,
                          torch.from_numpy(scale), torch.from_numpy(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a float32 sum of ~50 rows of |x| < 4 in another order, over 512:
    # n * eps * max / volume ~ 5e-8
    np.testing.assert_allclose(
        tops.global_avg_pool(st).numpy(), np.asarray(jops.global_avg_pool(sj)),
        rtol=1e-5, atol=1e-7,
    )
