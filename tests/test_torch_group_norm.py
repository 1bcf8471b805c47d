"""Group and layer norm and the per-label final series of the port against
the JAX package, on the same numpy inputs at fp32 on the CPU:
``masked_group_norm`` and ``MaskedGroupNorm`` / ``InputNorm`` (output and
input gradient, with an empty event and with G > 1), a depth-2 sparse
classifier with ``normalization=group|layer`` (logits and one train step's
gradients, the port on both backends against the JAX model on its plain
backend), and the per-label final series in 3D and 2D (parameter names and
counts, logits)."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_2d as jbatch2
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch3
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.models.blocks import InputNorm as JInputNorm
from sparseeventid_tpu.models.blocks import MaskedGroupNorm as JGroupNorm
from sparseeventid_tpu.ops import build_sparse_tensor as jbuild_st
from sparseeventid_tpu.ops.norm import masked_group_norm as jgroup_norm
from sparseeventid_tpu.train.supervised import make_loss_fn
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config import schema as tschema
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_2d as tbatch2
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch3
from sparseeventid_tpu_torch.models import InputNorm, MaskedGroupNorm
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.ops import build_sparse_tensor, masked_group_norm
from sparseeventid_tpu_torch.train import param_count
from sparseeventid_tpu_torch.train.losses import multi_head_loss


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _norm_inputs(c=8):
    """[3, 40, c] features; event 1 has 9 live rows, event 2 none."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, c)) * 2.0 + 0.7).astype(np.float32)
    mask = np.zeros((3, 40), bool)
    mask[0, :31] = True
    mask[1, :9] = True
    x = x * mask[..., None]
    gy = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    return x, mask, gy, scale, bias


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_masked_group_norm_matches_jax(groups):
    """Output and d/dx at rtol 1e-5 / atol 1e-6; the empty event gives 0."""
    x, mask, gy, scale, bias = _norm_inputs()

    def f(xj):
        out = jgroup_norm(xj, jnp.asarray(mask), groups, jnp.asarray(scale),
                          jnp.asarray(bias))
        return jnp.sum(out * gy), out

    (_, want), gx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = masked_group_norm(xt, torch.from_numpy(mask), groups,
                            torch.from_numpy(scale), torch.from_numpy(bias))
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-6)
    assert float(out.detach()[2].abs().max()) == 0.0
    assert float(xt.grad[2].abs().max()) == 0.0
    assert float(out.detach()[1, :9].abs().max()) > 0.1


def test_group_norm_module_and_input_norm_match_flax():
    """``MaskedGroupNorm`` (parameters ``scale``, ``bias``) and
    ``InputNorm`` (its norm under ``norm``) with the flax parameters."""
    x, mask, gy, scale, bias = _norm_inputs()
    params = {"scale": scale, "bias": bias}
    want = JGroupNorm().apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(mask))
    mod = MaskedGroupNorm(8)
    mod.load_state_dict(params_from_jax(params))
    got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(1)
    coords = np.full((2, 64, 3), -1, np.int32)
    feats = np.zeros((2, 64, 1), np.float32)
    for b, n in enumerate((40, 0)):
        lin = rng.choice(16**3, n, replace=False)
        coords[b, :n] = np.stack(np.unravel_index(lin, (16,) * 3), -1)
        feats[b, :n, 0] = rng.uniform(0.1, 3.0, n)
    sj = jbuild_st(jnp.asarray(coords), jnp.asarray(feats), (16,) * 3)
    st = build_sparse_tensor(torch.from_numpy(coords), torch.from_numpy(feats),
                             (16,) * 3)
    p1 = {"norm": {"scale": np.array([1.3], np.float32),
                   "bias": np.array([0.2], np.float32)}}
    want = JInputNorm().apply({"params": p1}, sj)
    norm = InputNorm(1)
    norm.load_state_dict(params_from_jax(p1))
    got = norm(st)
    np.testing.assert_allclose(got.feats.detach().numpy(), np.asarray(want.feats),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got.coords, st.coords)


# ---- depth-2 classifiers: group and layer norm, per-label final series

GRID3 = (16, 16, 16)
GRID2 = (3, 32, 32)
OVERRIDES = [
    "data=synthetic", "encoder.depth=2", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=8", "encoder.n_output_filters=8",
    "framework.min_capacity=64", "head.dropout=0.0", "head.hidden=16",
    "framework.remat=false",
]


def _cfgs(backend, extra=()):
    out = []
    for load in (jload, tload):
        cfg = load("synthetic", OVERRIDES + [f"framework.sparse_backend={backend}",
                                             *extra])
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_voxels=256)))
    return out


@pytest.fixture(scope="module")
def batch3():
    ds = SyntheticDataset(4, SyntheticEventConfig(image_size=GRID3, max_voxels=256),
                          seed=3)
    return ds.batch([0, 1])


@pytest.fixture(scope="module")
def batch2():
    ds = SyntheticDataset(4, SyntheticEventConfig(image_size=(32, 32, 32),
                                                  n_planes=3, max_voxels=256),
                          seed=5)
    return ds.batch([0, 1])


def _variables(cfg_j, sj, seed=4):
    """Flax variables with random running statistics (if any) and random
    norm scales and offsets, as numpy trees."""
    v = jbuild(cfg_j).init(jax.random.PRNGKey(0), sj, True)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        if key in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key in ("mean", "bias"):
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(draw, _np_tree(v["params"]))
    stats = jax.tree_util.tree_map_with_path(
        draw, _np_tree(v.get("batch_stats", {})))
    return params, stats


def _port(cfg_t, params, stats):
    model = tbuild(cfg_t)
    state = params_from_jax(params, stats)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("backend", ["window", "xla"])
@pytest.mark.parametrize("norm", ["group", "layer"])
def test_group_norm_classifier_logits_and_gradients_match_jax(
        norm, backend, batch3, one_torch_thread):
    """Logits at rtol 1e-4 / atol 1e-5 (train and eval mode are the same
    function: group norm keeps no running statistics), and every parameter
    gradient of the focal loss within test_torch_train_step.py's
    tolerance."""
    cfg_j, cfg_t = _cfgs("xla", [f"encoder.normalization={norm}"])[0], \
        _cfgs(backend, [f"encoder.normalization={norm}"])[1]
    sj = jbatch3(batch3["image"], GRID3, capacity=512)
    st = tbatch3(batch3["image"], GRID3, capacity=512)
    params, stats = _variables(cfg_j, sj)
    assert stats == {} and "scale" in params["encoder"]["series_0"]["block_0"]["conv1"]["norm"]
    lj = {k: jnp.asarray(batch3[k]) for k in OUTPUT_SHAPE}
    loss_fn = make_loss_fn(jbuild(cfg_j), JScheme.focal)
    (loss_j, (logits_j, _, _, _)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(params, {}, sj, lj, None, jax.random.PRNGKey(1),
                               True)
    want = params_from_jax(_np_tree(grads_j))

    model = _port(cfg_t, params, stats).train()
    logits, dropped = model(st)
    assert int(dropped) == 0
    loss, _ = multi_head_loss(logits, {k: torch.from_numpy(batch3[k])
                                       for k in OUTPUT_SHAPE},
                              tschema.LossBalanceScheme.focal)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(logits[k].detach().numpy(),
                                   np.asarray(logits_j[k]), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        evaluated, _ = model.eval()(st)
    for k in OUTPUT_SHAPE:
        torch.testing.assert_close(evaluated[k], logits[k].detach(), rtol=0, atol=0)
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=max(1e-4 * np.abs(g).max(), floor),
                                   err_msg=name)
    assert np.abs(want["encoder.series_0.block_0.conv1.norm.scale"].numpy()).max() > 0


def _names_and_counts(model):
    top = {}
    for name, p in model.named_parameters():
        head = name.split(".", 1)[0]
        top[head] = top.get(head, 0) + p.numel()
    return top


@pytest.mark.parametrize("dimension,merge", [(3, -1), (2, -1), (2, 1)])
def test_per_label_final_series_matches_jax(dimension, merge, batch3, batch2,
                                            one_torch_thread):
    """The names and parameter counts of tests/test_multiplane.py (a
    ``final_series_{label}`` and a ``head_{label}`` each; the heads hold as
    many parameters as the shared MultiHeadOutput), the flax tree carried
    over with no key left over, the series' kernel (3, 3, 3) for a merged
    2D model, and the logits in eval and train mode against JAX."""
    extra = ["encoder.per_label_final_series=true"]
    if dimension == 2:
        extra += ["data.dimension=2", "data.images=3",
                  f"encoder.plane_merge_depth={merge}"]
        image, grid, to_j, to_t = batch2["image"], GRID2, jbatch2, tbatch2
    else:
        image, grid, to_j, to_t = batch3["image"], GRID3, jbatch3, tbatch3
    cap = 1024 if dimension == 2 else 512
    cfg_j, cfg_t = _cfgs("xla", extra)
    sj = to_j(image, grid, capacity=cap)
    st = to_t(image, grid, capacity=cap)
    params, stats = _variables(cfg_j, sj)
    model = _port(cfg_t, params, stats)
    base = tbuild(_cfgs("xla", [e for e in extra if "per_label" not in e])[1])
    top, base_top = _names_and_counts(model), _names_and_counts(base)
    keys = list(OUTPUT_SHAPE)
    assert set(top) == {"encoder"} | {f"final_series_{k}" for k in keys} | {
        f"head_{k}" for k in keys}
    assert sum(top[f"head_{k}"] for k in keys) == base_top["head"]
    series = top["final_series_labelneutID"]
    assert param_count(model) == param_count(base) + 4 * series
    assert param_count(model) == sum(x.size for x in jax.tree_util.tree_leaves(params))
    k = model.final_series_labelneutID.block_0.conv1.w.shape[0]
    assert k == (27 if (dimension == 3 or merge >= 0) else 9)
    for train in (False, True):
        variables = {"params": params, "batch_stats": stats}
        if train:
            want, _ = jbuild(cfg_j).apply(variables, sj, True,
                                          mutable=["batch_stats", "diagnostics"])
        else:
            want = jbuild(cfg_j).apply(variables, sj, False)
        model.train(train)
        with torch.no_grad():
            got, dropped = model(st)
        assert int(dropped) == 0
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{key} train={train}")
