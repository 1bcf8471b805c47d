"""``convert.params_from_jax`` and ``models.build.init_parameters`` over
every model family: the whole flax variable tree of the JAX package's
``build_model`` (sparse with batch or group norm, per-label final series,
dense 3D and 2D, PointNet, DGCNN) lands on the port's ``build_model`` of the
same config with no key left over on either side and every shape equal; a
seeded initialisation fills every parameter in flax's families (2D and 3D
dense conv kernels LeCun-style, TNet ``fc3`` zero)."""

import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import image_size as jimage_size
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import (
    larcv_batch_to_dense,
    larcv_batch_to_pointcloud,
    larcv_batch_to_sparse_3d,
)
from sparseeventid_tpu.models.build import build_model as jbuild_model
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.models import build_model, init_parameters

BASE = ["encoder.depth=2", "encoder.blocks_per_layer=1",
        "encoder.n_initial_filters=4", "encoder.n_output_filters=8",
        "framework.min_capacity=64", "data.max_voxels=256", "head.hidden=16",
        "framework.sparse_backend=xla", "framework.remat=false"]
FAMILIES = {
    "sparse_batch": [],
    "sparse_group": ["encoder.normalization=group"],
    "per_label": ["encoder.per_label_final_series=true"],
    "dense_3d": ["framework.mode=dense"],
    "dense_2d_group": ["framework.mode=dense", "data.dimension=2",
                       "data.images=3", "encoder.normalization=layer",
                       "encoder.downsampling=pooling"],
    "pointnet": ["encoder=pointnet", "encoder.max_points=32"],
    "dgcnn": ["encoder=dgcnn", "encoder.max_points=32", "encoder.k=4",
              "encoder.emb_dims=32"],
}
GRID = (16, 16, 16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _flax_variables(cfg):
    model, mode = jbuild_model(cfg)
    image = SyntheticDataset(2, SyntheticEventConfig(image_size=GRID,
                                                     max_voxels=256)).batch([0, 1])["image"]
    if mode == "points":
        pts, mask = larcv_batch_to_pointcloud(image, cfg.encoder.max_points)
        x = (jnp.asarray(pts), jnp.asarray(mask))
    elif mode == "dense" and cfg.data.dimension == 2:
        x = jnp.zeros((2, *jimage_size(cfg)[:1], 16, 16, 1))
    elif mode == "dense":
        x = jnp.asarray(larcv_batch_to_dense(image, GRID))
    else:
        x = larcv_batch_to_sparse_3d(image, GRID, capacity=512)
    v = model.init(jax.random.PRNGKey(0), x, True)
    return mode, _np_tree(v["params"]), _np_tree(v.get("batch_stats", {}))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flax_tree_carries_over_with_no_key_left(family):
    ov = BASE + FAMILIES[family]
    mode, params, stats = _flax_variables(jload("synthetic", ov))
    model, mode_t = build_model(tload("synthetic", ov))
    assert mode_t == mode
    state = params_from_jax(params, stats)
    mine = model.state_dict()
    assert set(state) == set(mine), (set(state) ^ set(mine))
    for name, t in state.items():
        assert t.shape == mine[name].shape, name
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(
        jax.tree_util.tree_leaves(stats))
    assert len(state) == n_leaves
    model.load_state_dict(state)  # strict
    if family.startswith("dense"):
        weights = [n for n in state if n.endswith(".weight") and state[n].dim() > 2]
        assert {state[n].dim() for n in weights} == {5 if family == "dense_3d" else 4}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_parameters_fills_every_family(family):
    model, _ = build_model(tload("synthetic", BASE + FAMILIES[family]))
    for p in model.parameters():
        p.data.fill_(float("nan"))
    init_parameters(model, 0)
    named = dict(model.named_parameters())
    assert all(torch.isfinite(p).all() for p in named.values())
    for name, p in named.items():
        leaf = name.rsplit(".", 1)[-1]
        if "tnet.fc3" in name or leaf in ("bias", "b", "initial_b", "bottleneck_b"):
            assert float(p.abs().max()) == 0.0, name
        elif leaf == "scale":
            assert torch.equal(p, torch.ones_like(p)), name
        elif p.dim() in (4, 5):  # dense conv [out, in, *k]: LeCun over in * k
            std = float(p.std())
            want = math.sqrt(1.0 / math.prod(p.shape[1:]))
            assert 0.6 * want < std < 1.4 * want, name
    if family == "pointnet":
        assert "inner.encoder.input_tnet.fc3.weight" in named
