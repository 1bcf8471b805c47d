"""The dense model family of the port (``models/dense.py``) against the JAX
package's flax model, on the same numpy inputs at fp32 on the CPU, with the
weights carried by ``convert.params_from_jax``: 3D, 2D multiplane (planes
folded into the batch), odd grid sizes (flax's SAME padding), the pooling
downsample and group norm.  Logits in eval and train mode, the running
statistics after a train-mode forward (flax's biased variance and momentum
rules), the parameter gradients; and ``larcv_batch_to_dense``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config.schema import OUTPUT_SHAPE, ConvRepresentation
from sparseeventid_tpu.config.schema import DownSampling as JDown
from sparseeventid_tpu.config.schema import Norm as JNorm
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_dense as jdense
from sparseeventid_tpu.models.dense import DenseEventClassifier as JDense
from sparseeventid_tpu_torch.config import schema as tschema
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_dense
from sparseeventid_tpu_torch.models.dense import DenseEventClassifier, same_padding


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def test_larcv_batch_to_dense_equals_jax():
    ds = SyntheticDataset(4, SyntheticEventConfig(image_size=(16, 16, 16),
                                                  max_voxels=256), seed=2)
    image = ds.batch([0, 1, 2])["image"]
    image[1, 5, 3] = -999.0  # a voxel without a value is left out
    got = larcv_batch_to_dense(image, (16, 16, 16))
    want = jdense(image, (16, 16, 16))
    assert got.shape == (3, 16, 16, 16, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 100
    planes = np.zeros((2, 3, 8, 3), np.float32)  # 2D multiplane images
    with pytest.raises(ValueError, match="multiplane"):
        larcv_batch_to_dense(planes, (3, 16, 16))


@pytest.mark.parametrize("size,kernel,stride", [
    (16, 3, 1), (15, 3, 1), (16, 5, 1), (15, 2, 2), (16, 2, 2), (1, 2, 2)])
def test_same_padding_is_flax_s(size, kernel, stride):
    """(low, high) of lax's SAME: symmetric for odd kernels at stride 1,
    one at the high end for an odd size under the stride-2 kernel-2
    downsample."""
    lo, hi = same_padding(size, kernel, stride)
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert (lo, hi) == tuple(want)


CASES = {
    # name: (dimension, input shape, encoder overrides)
    "3d": (3, (2, 16, 16, 16, 1), {}),
    "3d_odd": (3, (2, 15, 9, 13, 1), {}),
    "3d_pooling_odd": (3, (2, 15, 9, 13, 1), {"downsampling": "pooling"}),
    "3d_group": (3, (2, 16, 16, 16, 1), {"normalization": "group"}),
    "2d_multiplane": (2, (2, 3, 32, 32, 1), {}),
    "2d_multiplane_pooling_odd": (2, (2, 3, 17, 23, 1),
                                  {"downsampling": "pooling"}),
}


def _encoders(overrides):
    base = dict(depth=2, n_initial_filters=4, n_output_filters=8,
                blocks_per_layer=1)
    j_kw, t_kw = dict(base), dict(base)
    if "downsampling" in overrides:
        j_kw["downsampling"] = JDown[overrides["downsampling"]]
        t_kw["downsampling"] = tschema.DownSampling[overrides["downsampling"]]
    if "normalization" in overrides:
        j_kw["normalization"] = JNorm[overrides["normalization"]]
        t_kw["normalization"] = tschema.Norm[overrides["normalization"]]
    return ConvRepresentation(**j_kw), tschema.ConvRepresentation(**t_kw)


def _input(shape, seed=0):
    """Sparse-ish positive charges on the grid, zero elsewhere."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 2.0, shape).astype(np.float32)
    return x * (rng.uniform(size=shape) < 0.2)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_classifier_matches_flax(case, one_torch_thread):
    """Eval logits (running statistics drawn at random), train logits and
    the running statistics they leave (rtol 1e-4 / atol 1e-5), and every
    parameter gradient of sum(logits^2) in train mode within rtol 1e-3 and
    an atol of 1e-4 of the tensor's largest |gradient|."""
    dimension, shape, overrides = CASES[case]
    enc_j, enc_t = _encoders(overrides)
    x = _input(shape)
    model_j = JDense(enc_j, OUTPUT_SHAPE, dimension=dimension, head_hidden=16,
                     head_dropout=0.0)
    v = model_j.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    params = _np_tree(v["params"])
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.2, a.shape)).astype(np.float32),
        _np_tree(v.get("batch_stats", {})))
    assert "down_norm_0" in params["encoder"]
    variables = {"params": params, "batch_stats": stats}

    planes = shape[1] if dimension == 2 else 1
    model = DenseEventClassifier(enc_t, OUTPUT_SHAPE, dimension, planes,
                                 head_hidden=16, head_dropout=0.0)
    state = params_from_jax(params, stats)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)

    want_eval = model_j.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got_eval, dropped = model.eval()(torch.from_numpy(x))
    assert int(dropped) == 0
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got_eval[k].numpy(), np.asarray(want_eval[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=f"eval {k}")

    def loss_j(p):
        out, mutated = model_j.apply({"params": p, "batch_stats": stats},
                                     jnp.asarray(x), True,
                                     mutable=["batch_stats"])
        return sum(jnp.sum(o**2) for o in out.values()), (out, mutated)

    (_, (want_train, mutated)), grads = jax.value_and_grad(
        loss_j, has_aux=True)(params)
    want = params_from_jax(_np_tree(grads), _np_tree(mutated.get("batch_stats", {})))
    got_train, _ = model.train()(torch.from_numpy(x))
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got_train[k].detach().numpy(),
                                   np.asarray(want_train[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"train {k}")
    sum((o**2).sum() for o in got_train.values()).backward()
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        assert not np.allclose(buf.numpy(), state[name].numpy())
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=max(1e-4 * np.abs(g).max(), floor),
                                   err_msg=name)
    assert float(named["encoder.initial.weight"].grad.abs().max()) > 0


def test_bfloat16_input_runs_in_float32():
    """A bfloat16 input gives the float32 logits of its float32 rounding,
    as flax promotes it to the float32 parameters."""
    enc_j, enc_t = _encoders({})
    x = _input((2, 16, 16, 16, 1))
    model = DenseEventClassifier(enc_t, OUTPUT_SHAPE, 3, head_hidden=16)
    from sparseeventid_tpu_torch.models import init_parameters

    init_parameters(model, 0).eval()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        low, _ = model(xb)
        ref, _ = model(xb.float())
    for k in OUTPUT_SHAPE:
        assert low[k].dtype == torch.float32
        assert torch.equal(low[k], ref[k])
