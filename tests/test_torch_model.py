"""The port's classifier against the flax model: the same flax variables,
carried over by ``params_from_jax``, must give the same logits at fp32,
the same parameter count, and the same eval metrics and softmax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.train import param_count
from sparseeventid_tpu.train.state import TrainState
from sparseeventid_tpu.train.supervised import make_eval_step as jeval
from sparseeventid_tpu.train.supervised import make_predict_step as jpredict
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config.schema import LossBalanceScheme
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.train import make_eval_step, make_predict_step

GRID = (16, 16, 16)
OVERRIDES = [
    "data=synthetic", "encoder.depth=1", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
    "run.minibatch_size=2", "framework.min_capacity=64",
]


def _cfgs(backend):
    ov = OVERRIDES + [f"framework.sparse_backend={backend}"]
    out = []
    for load in (jload, tload):
        cfg = load("synthetic", ov)
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_voxels=256)
        ))
    return out


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    batch = ds.batch([0, 1])
    sj = jbatch(batch["image"], GRID, capacity=512)
    st = tbatch(batch["image"], GRID, capacity=512)
    cfg_j, _ = _cfgs("xla")
    model_j = jbuild(cfg_j)
    variables = model_j.init(jax.random.PRNGKey(0), sj, True)
    rng = np.random.default_rng(4)
    # non-trivial running statistics, so eval-mode batch norm is exercised
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (
            rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
            else rng.normal(0.0, 0.2, x.shape)
        ).astype(np.float32),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    labels = {k: batch[k] for k in OUTPUT_SHAPE}
    return dict(sj=sj, st=st, params=params, stats=stats, labels=labels)


def _torch_model(backend, setup):
    _, cfg_t = _cfgs(backend)
    model = tbuild(cfg_t)
    model.load_state_dict(params_from_jax(setup["params"], setup["stats"]))
    return model.eval()


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_logits_match_flax(backend, setup):
    cfg_j, _ = _cfgs(backend)
    model_j = jbuild(cfg_j)
    want = model_j.apply(
        {"params": setup["params"], "batch_stats": setup["stats"]},
        setup["sj"], False,
    )
    model = _torch_model(backend, setup)
    with torch.no_grad():
        got, dropped = model(setup["st"])
    assert int(dropped) == 0
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5)


def test_param_count_matches_flax(setup):
    model = _torch_model("xla", setup)
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(setup["params"])
    # every flax leaf landed: parameters and running statistics
    assert len(params_from_jax(setup["params"], setup["stats"])) == len(
        model.state_dict()
    )


@pytest.mark.parametrize("scheme", ["focal", "even"])
def test_eval_and_predict_steps_match_flax(scheme, setup):
    cfg_j, _ = _cfgs("xla")
    model_j = jbuild(cfg_j)
    state = TrainState(setup["params"], setup["stats"], None, jnp.zeros((), jnp.int32))
    weights = None
    weights_t = None
    if scheme == "even":
        weights = {k: jnp.asarray([0.582, 1.417])
                   for k, n in OUTPUT_SHAPE.items() if n == 2}
        weights_t = {k: torch.tensor([0.582, 1.417])
                     for k, n in OUTPUT_SHAPE.items() if n == 2}
    labels_j = {k: jnp.asarray(v) for k, v in setup["labels"].items()}
    want = jeval(model_j, JScheme[scheme], class_weights=weights)(
        state, setup["sj"], labels_j, None
    )
    soft_j = jpredict(model_j)(state, setup["sj"])
    model = _torch_model("xla", setup)
    labels_t = {k: torch.from_numpy(v) for k, v in setup["labels"].items()}
    got = make_eval_step(model, LossBalanceScheme[scheme], weights_t)(
        setup["st"], labels_t
    )
    soft_t = make_predict_step(model)(setup["st"])
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6)
    assert int(got["overflow/dropped"]) == 0
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(soft_t[k].numpy(), np.asarray(soft_j[k]),
                                   rtol=1e-5, atol=1e-6)
