"""The port's checkpoints against the JAX package's: the index file and the
kept steps of a save sequence, the glob fallback, a bit-equal round trip,
encoder-only transfer (parameters, not running statistics), and a
frozen-encoder train step against the JAX ``optax.multi_transform`` step."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from sparseeventid_tpu.train.schedules import build_lr_schedule as jschedule
from sparseeventid_tpu.train.state import TrainState as JTrainState
from sparseeventid_tpu.train.supervised import make_train_step as jtrain_step
from sparseeventid_tpu.utils.checkpoint import CheckpointManager as JManager
from sparseeventid_tpu.utils.checkpoint import encoder_freeze_mask
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch
from sparseeventid_tpu_torch.models import build_sparse_classifier, init_parameters
from sparseeventid_tpu_torch.train import TrainState, build_optimizer
from sparseeventid_tpu_torch.train.trainer import build_training, step_generator
from sparseeventid_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    encoder_freeze_names,
    load_encoder_only,
)

GRID = (16, 16, 16)
OVERRIDES = [
    "data=synthetic", "encoder.depth=2", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=16", "encoder.n_output_filters=16",
    "run.minibatch_size=2", "framework.min_capacity=64", "head.dropout=0.0",
    "head.hidden=32", "mode.optimizer.lr_schedule=flat",
    "mode.optimizer.lr_schedule.peak_learning_rate=0.003",
    "mode.optimizer.weight_decay=0.01", "framework.sparse_backend=xla",
]
TRANSFER = ["mode.weights_location=source.pt", "mode.restore_encoder_only=true"]


def _cfg(load, extra=()):
    cfg = load("synthetic", OVERRIDES + list(extra))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_voxels=256))


@pytest.fixture(scope="module")
def batches():
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    return [ds.batch([2 * i, 2 * i + 1]) for i in range(3)]


def _inputs(batch):
    return (tbatch(batch["image"], GRID, capacity=512),
            {k: torch.from_numpy(batch[k]) for k in OUTPUT_SHAPE})


def _tiny_state():
    model = torch.nn.Linear(3, 2)
    opt, sched = build_optimizer(tload("synthetic").mode.optimizer, lambda s: 1.0,
                                 model.parameters())
    return TrainState(model, opt, sched)


# ---- the index file

SAVES = [2, 4, 6, 4, 8, 10, 12]  # seven saves, one step saved twice


def test_index_and_kept_steps_match_jax(tmp_path):
    jm = JManager(tmp_path / "jax", keep=5)
    tm = CheckpointManager(tmp_path / "port", keep=5)
    state = _tiny_state()
    for step in SAVES:
        jm.save({"w": np.zeros(2, np.float32)}, step)
        state.step = step
        tm.save(state)
        want = jm.index.read_text().replace(".msgpack", ".pt")
        assert tm.index.read_text() == want
        assert sorted(p.name for p in tm.dir.glob("step_*")) == sorted(
            p.name.replace(".msgpack", ".pt") for p in jm.dir.glob("step_*"))
    # the re-saved step 4 moved behind 6; the oldest, 2, was collected
    assert tm.index.read_text().splitlines() == ["latest: step_12.pt"] + [
        f"step: step_{s}.pt" for s in (6, 4, 8, 10, 12)]
    assert tm.latest_step() == jm.latest_step() == 12
    assert not list(tm.dir.glob("*.tmp"))


def test_latest_step_glob_fallback(tmp_path):
    jm = JManager(tmp_path / "jax")
    tm = CheckpointManager(tmp_path / "port")
    assert tm.latest_step() is None and jm.latest_step() is None
    for step in (3, 12, 7):
        (jm.dir / f"step_{step}.msgpack").write_bytes(b"")
        (tm.dir / f"step_{step}.pt").write_bytes(b"")
    assert tm.latest_step() == jm.latest_step() == 12
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_tiny_state(), "cpu")


# ---- round trip and transfer

def _trained(batches, steps=2):
    cfg = _cfg(tload)
    state, step, _ = build_training(cfg, 4, None, torch.device("cpu"))
    for i in range(steps):
        step(*_inputs(batches[i]), step_generator(0, i, "cpu"))
    return cfg, state, step


def test_round_trip_is_bit_equal(tmp_path, batches):
    """Parameters, running statistics, AdamW moments, the schedule and the
    step restore to the same bits, and one more step from each gives the
    same parameters."""
    cfg, state, step = _trained(batches)
    CheckpointManager(tmp_path).save(state)
    fresh, fresh_step, _ = build_training(cfg, 4, None, torch.device("cpu"))
    assert CheckpointManager(tmp_path).restore(fresh, "cpu") == state.step == 2
    want = state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    a, b = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in b["state"].items():
        for k, v in s.items():
            assert torch.equal(a["state"][i][k], v), (i, k)
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    for st, stp in ((state, step), (fresh, fresh_step)):
        stp(*_inputs(batches[2]), step_generator(0, 2, "cpu"))
    after = dict(state.model.named_parameters())
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, after[n]), n


def test_load_encoder_only_leaves_running_statistics(tmp_path, batches):
    _, source, _ = _trained(batches)  # train mode moved its statistics
    CheckpointManager(tmp_path).save(source)
    target = init_parameters(build_sparse_classifier(_cfg(tload)), 1)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    names = load_encoder_only(target, tmp_path / "step_2.pt", "cpu")
    assert names == encoder_freeze_names(target)
    assert names and all(n.startswith("encoder.") for n in names)
    src = source.model.state_dict()
    for k, v in target.state_dict().items():
        if k in names:
            assert torch.equal(v, src[k]), k
        else:  # the head and every running statistic stay the target's
            assert torch.equal(v, before[k]), k
    moved = [k for k, _ in target.named_buffers() if not torch.equal(src[k], before[k])]
    assert moved  # the source's statistics differ: leaving them is visible


# ---- a frozen-encoder step against the JAX multi_transform step

def test_frozen_encoder_step_matches_jax_multi_transform(batches):
    """Two steps from the same state with the encoder frozen: the port's
    encoder parameters do not move (nor the JAX ones), every head parameter
    and running statistic follows the JAX step within the tolerance of
    tests/test_torch_train_step.py (rtol 1e-3; statistics 1e-5), and so do
    the metrics."""
    cfg_j = _cfg(jload)
    model_j = jbuild(cfg_j)
    variables = model_j.init(jax.random.PRNGKey(0),
                             jbatch(batches[0]["image"], GRID, capacity=512), True)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))
    params, stats = to_np(variables["params"]), to_np(variables["batch_stats"])
    sched = jschedule(cfg_j.mode.optimizer.lr_schedule, 4, 1)
    opt = optax.multi_transform(
        {"trainable": jbuild_optimizer(cfg_j.mode.optimizer, sched),
         "frozen": optax.set_to_zero()}, encoder_freeze_mask)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state_j = JTrainState(pj, jax.tree_util.tree_map(jnp.asarray, stats),
                          opt.init(pj), jnp.zeros((), jnp.int32))
    step_j = jax.jit(jtrain_step(model_j, opt, JScheme.focal, sched))

    start = params_from_jax(params, stats)
    state, step, _ = build_training(_cfg(tload, TRANSFER), 4, start, torch.device("cpu"))
    frozen = encoder_freeze_names(state.model)
    trainable = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for n, p in state.model.named_parameters():
        assert (n in frozen) == (not p.requires_grad) == (id(p) not in trainable)
    for i in range(2):
        sj = jbatch(batches[i]["image"], GRID, capacity=512)
        lj = {k: jnp.asarray(batches[i][k]) for k in OUTPUT_SHAPE}
        state_j, mj = step_j(state_j, sj, lj, None, jax.random.PRNGKey(5))
        mt = step(*_inputs(batches[i]))
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    want = params_from_jax(to_np(state_j.params), to_np(state_j.batch_stats))
    got = state.model.state_dict()
    buffers = {n for n, _ in state.model.named_buffers()}
    for name, v in got.items():
        if name in frozen:
            assert torch.equal(v, start[name]), name
            assert torch.equal(want[name], start[name]), name
        elif name in buffers:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            assert not torch.equal(v, start[name]), name
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-3,
                                       atol=1e-6, err_msg=name)
    assert any(not torch.equal(got[n], start[n]) for n in buffers
               if n.startswith("encoder."))
