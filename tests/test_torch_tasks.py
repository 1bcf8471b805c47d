"""The port's SimCLR, vertex-finding and weak-label tasks against the JAX
package's, on the same numpy inputs: the NT-Xent loss, ``to_dense`` /
``from_dense``, the vertex labels, loss, prediction and metrics, the
energy-window fit, and whole depth-2 models (the JAX model on its plain
``xla`` backend, the port's on its plain backend) from the same weights,
carried across by ``convert.params_from_jax``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config.schema import ConvRepresentation as JEnc
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.augment import augment_larcv_batch as jaugment
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_2d as j2d
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as j3d
from sparseeventid_tpu.ops import from_dense as jfrom_dense
from sparseeventid_tpu.ops import to_dense as jto_dense
from sparseeventid_tpu.ops.sparse_tensor import SparseTensor as JSparse
from sparseeventid_tpu.train import losses as jlosses
from sparseeventid_tpu.train import representation as jrep
from sparseeventid_tpu.train import unsupervised as junsup
from sparseeventid_tpu.train import vertex as jvertex
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config.schema import ConvRepresentation as TEnc
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_2d as t2d
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as t3d
from sparseeventid_tpu_torch.models import capacity_schedule
from sparseeventid_tpu_torch.ops import SparseTensor as TSparse
from sparseeventid_tpu_torch.ops import from_dense as tfrom_dense
from sparseeventid_tpu_torch.ops import to_dense as tto_dense
from sparseeventid_tpu_torch.train import losses as tlosses
from sparseeventid_tpu_torch.train import representation as trep
from sparseeventid_tpu_torch.train import unsupervised as tunsup
from sparseeventid_tpu_torch.train import vertex as tvertex
from sparseeventid_tpu_torch.train.tasks import augment_views

from _torch_port_common import both

ENC = dict(depth=2, n_initial_filters=8, n_output_filters=16, blocks_per_layer=1)
GRID = (16, 16, 16)
GRID_2D = (3, 32, 32)
VIEW_VOXELS = 200


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _assert_grads(model, grads_j, stats_j=None):
    """Every parameter gradient within rtol 1e-3 and an atol of 1e-4 of that
    tensor's largest |gradient|, but no less than 1e-5 of the largest of any
    (a conv bias ahead of a batch norm has a true gradient of 0: both sides
    return rounding noise); the running statistics within 1e-5."""
    want = params_from_jax(_np_tree(grads_j), _np_tree(stats_j or {}))
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=1e-3,
            atol=max(1e-4 * np.abs(g).max(), floor), err_msg=name)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ---- NT-Xent

def test_nt_xent_loss_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    z1, z2 = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    z2[3] = 0.0  # an empty view: the smooth normalisation keeps it finite
    want, (g1, g2) = jax.value_and_grad(
        lambda a, b: jlosses.nt_xent_loss(a, b, 0.1), argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    t1, t2 = (torch.from_numpy(z).requires_grad_(True) for z in (z1, z2))
    got = tlosses.nt_xent_loss(t1, t2, 0.1)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g1), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(g2), rtol=1e-5, atol=1e-7)
    assert np.isfinite(t2.grad.numpy()).all()
    for n, k in ((6, 1), (6, 5), (2, 5)):  # (2, 5): k capped at 2n - 1
        a, b = z1[:n], z1[:n] + 0.3 * z2[:n]
        got_k = tlosses.nt_xent_top_k_accuracy(torch.from_numpy(a),
                                               torch.from_numpy(b), 0.1, k)
        want_k = jlosses.nt_xent_top_k_accuracy(jnp.asarray(a), jnp.asarray(b),
                                                0.1, k)
        assert float(got_k) == float(want_k), (n, k)


# ---- to_dense / from_dense

def test_to_dense_and_from_dense_match_jax():
    rng = np.random.default_rng(1)
    coords = np.full((2, 64, 3), -1, np.int32)
    coords[:, :40] = rng.integers(0, 8, (2, 40, 3))
    feats = rng.integers(-3, 4, (2, 64, 5)).astype(np.float32)
    sj, st = both(coords, feats, (8, 8, 8))
    np.testing.assert_array_equal(tto_dense(st).numpy(), np.asarray(jto_dense(sj)))
    # repeated keys add up; rows past n_active are dropped though they hold
    # a site and features
    c = np.array([[[1, 2, 3], [1, 2, 3], [0, 0, 0], [5, 5, 5]]], np.int32)
    f = np.arange(1, 9, dtype=np.float32).reshape(1, 4, 2)
    n = np.array([3], np.int32)
    dense_j = jto_dense(JSparse(jnp.asarray(c), jnp.asarray(f), jnp.asarray(n),
                                (8, 8, 8)))
    dense_t = tto_dense(TSparse(torch.from_numpy(c), torch.from_numpy(f),
                                torch.from_numpy(n), (8, 8, 8)))
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    assert dense_t[0, 1, 2, 3].tolist() == [4.0, 6.0]
    assert float(dense_t[0, 5, 5, 5].abs().sum()) == 0.0
    dense = rng.integers(-1, 2, (2, 6, 5, 7, 3)).astype(np.float32)
    dense *= rng.random((2, 6, 5, 7, 1)) < 0.3
    for cap in (64, 20):  # 20: fewer than the nonzero sites, kept in key order
        a = tfrom_dense(torch.from_numpy(dense), cap)
        b = jfrom_dense(jnp.asarray(dense), cap)
        for x, y in ((a.coords, b.coords), (a.feats, b.feats),
                     (a.n_active, b.n_active)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert a.grid_shape == tuple(b.grid_shape)


# ---- vertex finding

def test_vertex_labels_loss_and_metrics_match_jax():
    rng = np.random.default_rng(2)
    full, anchor = (64, 32, 80), (8, 4, 10)
    vertex = (rng.random((5, 3)) * np.array(full)).astype(np.float32)
    vertex[0] = 0.0
    vertex[1] = np.array(full, np.float32) - 1e-3
    label = rng.integers(0, 3, 5).astype(np.int32)
    pred = rng.standard_normal((5, *anchor, 4)).astype(np.float32) * 2
    logits = rng.standard_normal((5, 3)).astype(np.float32)
    want = jvertex.build_vertex_labels(jnp.asarray(vertex), anchor, full)
    got = tvertex.build_vertex_labels(torch.from_numpy(vertex), anchor, full)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    total_j, parts_j = jvertex.vertex_loss(jnp.asarray(pred), jnp.asarray(logits),
                                           *want, jnp.asarray(label))
    total_t, parts_t = tvertex.vertex_loss(torch.from_numpy(pred),
                                           torch.from_numpy(logits), *got,
                                           torch.from_numpy(label))
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-6)
    for k in parts_j:
        np.testing.assert_allclose(float(parts_t[k]), float(parts_j[k]),
                                   rtol=1e-6, err_msg=k)
    pv_j = jvertex.predict_vertex(jnp.asarray(pred), anchor, full)
    pv_t = tvertex.predict_vertex(torch.from_numpy(pred), anchor, full)
    np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), rtol=1e-6)
    m_j = jvertex.vertex_resolution_metrics(pv_j, jnp.asarray(vertex))
    m_t = tvertex.vertex_resolution_metrics(pv_t, torch.from_numpy(vertex))
    assert set(m_t) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-6,
                                   err_msg=k)


def _batch(n_planes=1, seed=0, b=4):
    if n_planes > 1:
        cfg = SyntheticEventConfig(image_size=(32, 32, 32), n_planes=3,
                                   max_voxels=128)
    else:
        cfg = SyntheticEventConfig(image_size=GRID, max_voxels=256)
    return SyntheticDataset(8, cfg, seed=seed).batch(list(range(b)))


def test_vertex_model_matches_jax(one_torch_thread):
    """The whole VertexModel from the same weights: the anchor map and event
    logits within rtol 1e-3, the loss and every parameter gradient too.  The
    3x3x3 head conv carries across only with its kernel permuted, not
    transposed."""
    batch = _batch()
    caps = capacity_schedule(256, 2, 0.5, 64)
    full, anchor = GRID, tuple(g // 4 for g in GRID)
    vertex = jnp.asarray(batch["vertex"])
    label = jnp.asarray(batch["labelneutID"])
    sj = j3d(batch["image"], GRID, capacity=caps[0])
    st = t3d(batch["image"], GRID, capacity=caps[0])
    jmodel = jvertex.VertexModel(JEnc(**ENC), dimension=3, capacities=caps)
    variables = jmodel.init(jax.random.PRNGKey(0), sj, True)

    def loss_fn(params):
        (pred, logits), mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, sj, True,
            mutable=["batch_stats"])
        labels = jvertex.build_vertex_labels(vertex, anchor, full)
        loss, parts = jvertex.vertex_loss(pred, logits, *labels, label)
        return loss, (pred, logits, parts, mutated["batch_stats"])

    (loss_j, (pred_j, logits_j, parts_j, stats_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    model = tvertex.VertexModel(TEnc(**ENC), dimension=3, capacities=caps)
    model.load_state_dict(params_from_jax(_np_tree(variables["params"]),
                                          _np_tree(variables["batch_stats"])))
    model.train()
    pred, logits, dropped = model(st)
    loss, metrics = tvertex.vertex_metrics(
        pred, logits, dropped, torch.from_numpy(batch["vertex"]),
        torch.from_numpy(batch["labelneutID"]), anchor, full)
    loss.backward()
    assert int(dropped) == 0
    assert pred.shape == (4, *anchor, 4)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-3)
    for k in parts_j:
        np.testing.assert_allclose(float(metrics[k]), float(parts_j[k]),
                                   rtol=1e-3, err_msg=k)
    _assert_grads(model, grads_j, stats_j)


# ---- SimCLR

def _views(dimension):
    """The two augmented views of one batch, made by the port's view
    function from a config (seeded run.seed + 101) and by the JAX trainer's
    recipe with the JAX package's augment: the same arrays."""
    ov = ["name=simclr", f"data.aug_max_voxels={VIEW_VOXELS}", "run.seed=3"]
    if dimension == 2:
        batch, grid = _batch(n_planes=3), GRID_2D
        ov += ["data.dimension=2", "data.max_voxels=128"]
    else:
        batch, grid = _batch(), GRID
        ov += ["data.max_voxels=256"]
    cfg = tload("synthetic", ov)
    vm = min(VIEW_VOXELS, cfg.data.max_voxels)
    view = augment_views(cfg, grid)
    got = [view(batch["image"]) for _ in range(2)]
    rng = np.random.default_rng(3 + 101)
    want = []
    for _ in range(2):
        image = batch["image"]
        if dimension == 2:
            b, p, n, f = image.shape
            out = jaugment(image.reshape(b * p, n, f), (grid[2], grid[1]), rng)
            out = out.reshape(b, p, n, f)
        else:
            out = jaugment(image, grid, rng)
        want.append(out[..., :vm, :])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], got[1])
    return got, grid, vm


@pytest.mark.parametrize("dimension", [3, 2])
def test_simclr_model_matches_jax(dimension, one_torch_thread):
    """Two views through one encoder from the same weights: z1, z2, the
    loss, top-1 / top-5 and every parameter gradient within rtol 1e-3; the
    encoder's running statistics, updated once a view, within 1e-5."""
    (v1, v2), grid, vm = _views(dimension)
    planes = grid[0] if dimension == 2 else 1
    caps = capacity_schedule(vm * planes, 2, 0.5, 64)
    to_j, to_t = (j2d, t2d) if dimension == 2 else (j3d, t3d)
    s1j, s2j = (to_j(v, grid, capacity=caps[0]) for v in (v1, v2))
    s1t, s2t = (to_t(v, grid, capacity=caps[0]) for v in (v1, v2))
    jmodel = jrep.RepresentationModel(JEnc(**ENC), dimension=dimension,
                                      capacities=caps)
    variables = jmodel.init(jax.random.PRNGKey(1), s1j, s2j, True)

    def loss_fn(params):
        (z1, z2), mutated = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            s1j, s2j, True, mutable=["batch_stats"])
        return jlosses.nt_xent_loss(z1, z2, 0.1), (z1, z2, mutated["batch_stats"])

    (loss_j, (z1j, z2j, stats_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])

    model = trep.RepresentationModel(TEnc(**ENC), dimension=dimension,
                                     capacities=caps)
    model.load_state_dict(params_from_jax(_np_tree(variables["params"]),
                                          _np_tree(variables["batch_stats"])))
    model.train()
    z1, z2, dropped = model(s1t, s2t)
    loss = tlosses.nt_xent_loss(z1, z2, 0.1)
    loss.backward()
    metrics = trep.simclr_metrics(loss.detach(), z1.detach(), z2.detach(),
                                  dropped)
    assert int(dropped) == 0
    for a, b in ((z1, z1j), (z2, z2j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(float(metrics["loss/loss"]), float(loss_j),
                               rtol=1e-3)
    for k in (1, 5):
        assert float(metrics[f"acc/top{k}"]) == float(
            jlosses.nt_xent_top_k_accuracy(z1j, z2j, 0.1, k))
    _assert_grads(model, grads_j, stats_j)


# ---- weak labels

def test_weak_label_window_matches_jax():
    """The fitted window of the same energies in one process (the same
    scipy): equal to 1e-12, and so are the labels."""
    rng = np.random.default_rng(5)
    energies = np.concatenate([rng.normal(10, 1, 500),
                               rng.exponential(5, 500) + 12])
    want = junsup.weak_labels_from_energy(energies)
    got = tunsup.weak_labels_from_energy(energies)
    np.testing.assert_allclose(got["window"], want["window"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["weak_label"], want["weak_label"])
    assert 0 < got["weak_label"].sum() < 1000
    x = np.linspace(0, 30, 50)
    np.testing.assert_allclose(tunsup.expgauss(x, 100.0, 10.0, 1.0, 0.5),
                               junsup.expgauss(x, 100.0, 10.0, 1.0, 0.5),
                               rtol=0, atol=1e-12)
    fixed = tunsup.weak_labels_from_energy(energies, (9.0, 11.0))
    np.testing.assert_array_equal(
        fixed["weak_label"],
        junsup.weak_labels_from_energy(energies, (9.0, 11.0))["weak_label"])


def test_weak_label_percentile_fallback_matches_jax(monkeypatch):
    """Where the fit fails, both take the 30th-70th percentiles."""
    def fail(*args, **kwargs):
        raise RuntimeError("no fit")

    monkeypatch.setattr(junsup, "fit_energy_spectrum", fail)
    monkeypatch.setattr(tunsup, "fit_energy_spectrum", fail)
    energies = np.random.default_rng(6).gamma(2.0, 3.0, 300)
    want = junsup.weak_labels_from_energy(energies)
    got = tunsup.weak_labels_from_energy(energies)
    np.testing.assert_array_equal(got["window"], np.percentile(energies, [30, 70]))
    np.testing.assert_allclose(got["window"], want["window"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["weak_label"], want["weak_label"])
