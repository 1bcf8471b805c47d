"""The point-cloud models of the port (``models/pointnet.py``,
``models/dgcnn.py``) against the JAX package's flax models, on the same
numpy inputs at fp32 on the CPU, with the weights carried by
``convert.params_from_jax``: PointNet logits and gradients, its mask
invariance (as tests/test_model_families.py) and its TNet's identity at
initialisation; DGCNN's kNN on integer coordinates with tied distances
(``jax.lax.top_k`` order), its edge features and logits, 3D and
multiplane; ``larcv_batch_to_pointcloud`` and ``global_max_pool``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_pointcloud as jpoints
from sparseeventid_tpu.models.dgcnn import DGCNNClassifier as JDGCNN
from sparseeventid_tpu.models.dgcnn import edge_features as jedges
from sparseeventid_tpu.models.dgcnn import knn_indices as jknn
from sparseeventid_tpu.models.pointnet import PointNetClassifier as JPointNet
from sparseeventid_tpu.ops import build_sparse_tensor as jbuild_st
from sparseeventid_tpu.ops.pool import global_max_pool as jmax_pool
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_pointcloud
from sparseeventid_tpu_torch.models import init_parameters
from sparseeventid_tpu_torch.models.dgcnn import DGCNNClassifier, edge_features, knn_indices
from sparseeventid_tpu_torch.models.pointnet import PointNetClassifier
from sparseeventid_tpu_torch.ops import build_sparse_tensor, global_max_pool


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _image(b=2, seed=0):
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=(16, 16, 16)),
                          seed=seed)
    return ds.batch(list(range(b)))["image"]


@pytest.mark.parametrize("shuffle", [False, True])
def test_larcv_batch_to_pointcloud_equals_jax(shuffle):
    """The first max_points valid voxels, or a generator's choice of them:
    the same points for the same seed."""
    image = _image(3)
    gen = (lambda: np.random.default_rng(7)) if shuffle else (lambda: None)
    pts, mask = larcv_batch_to_pointcloud(image, 48, gen())
    pj, mj = jpoints(image, 48, gen())
    np.testing.assert_array_equal(pts, pj)
    np.testing.assert_array_equal(mask, mj)
    assert pts.shape == (3, 48, 4) and mask.all()
    wide, wide_mask = larcv_batch_to_pointcloud(image, 4096)
    assert (~wide_mask).any() and np.all(wide[~wide_mask] == 0)
    with pytest.raises(ValueError, match="multiplane"):
        larcv_batch_to_pointcloud(np.zeros((2, 3, 8, 3), np.float32), 16)


def test_global_max_pool_equals_jax():
    rng = np.random.default_rng(2)
    coords = np.full((3, 32, 3), -1, np.int32)
    feats = np.zeros((3, 32, 5), np.float32)
    for b, n in enumerate((20, 0, 7)):
        lin = rng.choice(8**3, n, replace=False)
        coords[b, :n] = np.stack(np.unravel_index(lin, (8,) * 3), -1)
        feats[b, :n] = rng.standard_normal((n, 5)) - 3.0
    got = global_max_pool(build_sparse_tensor(
        torch.from_numpy(coords), torch.from_numpy(feats), (8,) * 3))
    want = jmax_pool(jbuild_st(jnp.asarray(coords), jnp.asarray(feats), (8,) * 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1].abs().max()) == 0.0 and float(got[0].max()) < 0


def _cloud(b=2, p=48, seed=0):
    pts, mask = jpoints(_image(b, seed), p)
    return pts, mask


def _ties():
    """Integer coordinates on a coarse lattice: many equal distances."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 3, (2, 24, 3)).astype(np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 17:] = False
    pts[1, 17:] = 1.0  # padded rows sit on valid points' coordinates
    return pts, mask


def test_knn_breaks_ties_as_jax_top_k():
    """On integer coordinates with tied distances, the same indices as
    ``jax.lax.top_k`` (equal distances, lower index first); each point is
    among its own neighbours; padded points are never chosen."""
    pts, mask = _ties()
    got = knn_indices(torch.from_numpy(pts), torch.from_numpy(mask), 6)
    want = jknn(jnp.asarray(pts), jnp.asarray(mask), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
    assert (np.sort(d, -1)[..., :7][..., 1:] == np.sort(d, -1)[..., :6]).any()
    assert np.all(got.numpy()[1, :17] < 17)
    assert all(i in got.numpy()[0, i] for i in range(24))
    # jax.lax.top_k's tie order on a small case
    assert jax.lax.top_k(jnp.asarray([1, 3, 3, 3, 0]), 2)[1].tolist() == [1, 2]
    # multiplane [B, planes, P, F]
    pm = np.stack([pts, pts[:, ::-1]], 1)
    mm = np.stack([mask, mask[:, ::-1]], 1)
    np.testing.assert_array_equal(
        knn_indices(torch.from_numpy(pm), torch.from_numpy(mm), 4).numpy(),
        np.asarray(jknn(jnp.asarray(pm), jnp.asarray(mm), 4)))


def test_edge_features_equal_jax():
    pts, mask = _ties()
    idx = np.array(jknn(jnp.asarray(pts), jnp.asarray(mask), 5))
    got = edge_features(torch.from_numpy(pts), torch.from_numpy(idx))
    want = jedges(jnp.asarray(pts), jnp.asarray(idx))
    assert got.shape == (2, 24, 5, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _variables(model_j, pts, mask, seed=3):
    """Flax's initial parameters, the same with PointNet's TNets moved off
    the identity (their ``fc3`` drawn at random), and random running
    statistics, as numpy trees."""
    v = model_j.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
                     True)
    rng = np.random.default_rng(seed)
    params = _np_tree(v["params"])
    moved = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(0.0, 0.05, a.shape).astype(np.float32)
                      if "fc3" in str(p) else a), params)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.2, a.shape)).astype(np.float32),
        _np_tree(v["batch_stats"]))
    return params, moved, stats


def _compare(model_j, model, pts, mask):
    """Eval and train logits (rtol 1e-4 / atol 1e-5; train rtol 1e-3 after
    the 1024-wide norms) and the running statistics after the train
    forward, with the TNets moved off the identity; the gradients of
    sum(logits^2) from flax's initialisation, every tensor within rtol 1e-3
    and an atol of 1e-3 of its largest |gradient| (no less than 1e-5 of
    the largest gradient of any parameter: a Dense bias ahead of a norm
    has a true gradient of 0).  A TNet away from the identity makes the
    max pools' choice of point sensitive to float32 rounding (a change of
    1e-5 in the input moves the port's own gradients by 8%), so gradients
    are held against JAX where the transform is the identity.  -> (the
    flax ``losses`` collection of the train forward, the port model's
    ``tnet_ortho`` after it)."""
    params, moved, stats = _variables(model_j, pts, mask)
    state = params_from_jax(moved, stats)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    xj, mj = jnp.asarray(pts), jnp.asarray(mask)
    want = model_j.apply({"params": moved, "batch_stats": stats}, xj, mj, False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pts), torch.from_numpy(mask))
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"eval {k}")

    def train_j(p):
        out, mutated = model_j.apply({"params": p, "batch_stats": stats}, xj, mj,
                                     True, mutable=["batch_stats", "losses"])
        return sum(jnp.sum(o**2) for o in out.values()), (out, mutated)

    _, (want_t, mutated) = train_j(moved)
    ref = params_from_jax(moved, _np_tree(mutated["batch_stats"]))
    with torch.no_grad():
        got_t = model.train()(torch.from_numpy(pts), torch.from_numpy(mask))
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got_t[k].numpy(), np.asarray(want_t[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=f"train {k}")
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    penalty = getattr(model, "tnet_ortho", None)

    grads = jax.grad(lambda p: train_j(p)[0])(params)
    ref = params_from_jax(_np_tree(grads))
    model.load_state_dict(params_from_jax(params, stats))
    out = model.train()(torch.from_numpy(pts), torch.from_numpy(mask))
    sum((o**2).sum() for o in out.values()).backward()
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(ref[n].abs().max()) for n in named)
    for name, p in named.items():
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=max(1e-3 * np.abs(g).max(), floor),
                                   err_msg=name)
    return mutated, penalty


@pytest.mark.parametrize("use_tnet", [True, False])
def test_pointnet_matches_flax(use_tnet, one_torch_thread):
    pts, mask = _cloud(p=48)
    mask[1, 30:] = False
    pts[1, 30:] = 0.0
    model_j = JPointNet(OUTPUT_SHAPE, use_tnet=use_tnet, head_hidden=32,
                        dropout=0.0)
    model = PointNetClassifier(OUTPUT_SHAPE, 4, 1, use_tnet=use_tnet,
                               head_hidden=32, dropout=0.0)
    mutated, penalty = _compare(model_j, model, pts, mask)
    if use_tnet:  # the penalty is computed, and kept out of the loss
        np.testing.assert_allclose(float(penalty),
                                   float(mutated["losses"]["tnet_ortho"][0]),
                                   rtol=1e-4)
        assert float(penalty) > 0


def test_pointnet_mask_invariance_and_identity_tnet():
    """Padded points do not move the output (tests/test_model_families.py);
    a fresh TNet's ``fc3`` is zero, so its transform is the identity."""
    pts, mask = _cloud(p=64)
    mask[:, 40:] = False
    model = init_parameters(PointNetClassifier(OUTPUT_SHAPE, 4), 0).eval()
    tnet = model.encoder.input_tnet
    assert float(tnet.fc3.weight.abs().max()) == 0 == float(tnet.fc3.bias.abs().max())
    assert float(model.encoder.feature_tnet.fc3.weight.abs().max()) == 0
    assert float(model.encoder.mlp1.fc0.weight.abs().max()) > 0
    x, m = torch.from_numpy(pts * mask[..., None]), torch.from_numpy(mask)
    with torch.no_grad():
        out1 = model(x, m)
        out2 = model(torch.where(m[..., None], x, 123.0), m)
        transformed, penalty = tnet(x, m)
    for k in out1:
        torch.testing.assert_close(out1[k], out2[k], rtol=1e-4, atol=1e-5)
    assert torch.equal(transformed, x) and float(penalty) == 0.0


@pytest.mark.parametrize("multiplane", [False, True])
def test_dgcnn_matches_flax(multiplane, one_torch_thread):
    pts, mask = _cloud(p=32)
    mask[0, 25:] = False
    pts[0, 25:] = 0.0
    planes = 1
    if multiplane:  # [B, 3, P, F], the planes sharing the weights
        pts = np.stack([pts, pts[:, ::-1], pts * 0.5], axis=1)
        mask = np.stack([mask, mask[:, ::-1], mask], axis=1)
        planes = 3
    model_j = JDGCNN(OUTPUT_SHAPE, k=5, emb_dims=64, head_hidden=32, dropout=0.0)
    model = DGCNNClassifier(OUTPUT_SHAPE, 4, planes, k=5, emb_dims=64,
                            head_hidden=32, dropout=0.0)
    _compare(model_j, model, pts, mask)
