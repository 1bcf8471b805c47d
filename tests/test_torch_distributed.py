"""The port's data parallelism (``parallel/mesh.py``) on the CPU over gloo,
against the JAX package's ``shard_map`` counterparts on the conftest's
virtual CPU devices and against the port's own one-process runs.

The port's ranks are spawned processes that import only torch and the port
(``tests/torch_dist_worker.py``); the JAX side runs in the test process.
(a) sync batch-norm statistics over two ranks with unequal live counts;
(b) NT-Xent over two ranks; (c) one supervised data-parallel step against
JAX's ``make_dp_train_step``; (d) the same step against the port's
one-process step on the four events; (e) a group of one gives the bits of
no group; (f) train and inference through the entry points with
``run.distributed=true``, every task; (g) the bootstrap.
"""

import dataclasses
import datetime
import logging
import socket
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.ops.norm import masked_batch_stats as jstats
from sparseeventid_tpu.parallel import make_dp_train_step
from sparseeventid_tpu.train.losses import nt_xent_loss as jnt_xent
from sparseeventid_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from sparseeventid_tpu.train.schedules import build_lr_schedule as jschedule
from sparseeventid_tpu.train.state import TrainState as JTrainState
from sparseeventid_tpu.train.supervised import make_loss_fn
from sparseeventid_tpu.train.supervised import make_train_step as jtrain_step
from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.ops.norm import masked_batch_stats
from sparseeventid_tpu_torch.parallel import mesh
from sparseeventid_tpu_torch.train.evaluate import validate
from sparseeventid_tpu_torch.train.tasks import TASKS


def _mesh2():
    return Mesh(np.array(jax.devices("cpu")[:2]), ("data",))


@pytest.fixture(scope="module")
def jax_state():
    """The JAX model's initial variables on the step's config (dropout 0,
    plain ``xla`` backend) and the port's ``state_dict`` of them."""
    ov = [o for o in W.STEP_OVERRIDES if o != "run.compute_mode=CPU"]
    cfg = jload("synthetic", ov)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_voxels=256))
    batch = W.step_batch()
    variables = jbuild(cfg).init(
        jax.random.PRNGKey(0), jbatch(batch["image"][:2], W.GRID, capacity=512), True)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))
    params, stats = to_np(variables["params"]), to_np(variables["batch_stats"])
    return dict(cfg=cfg, batch=batch, params=params, stats=stats,
                state_dict=params_from_jax(params, stats))


@pytest.fixture(scope="module")
def pair(jax_state, tmp_path_factory):
    """(a)-(d) on two gloo ranks."""
    tmp = tmp_path_factory.mktemp("pair")
    torch.save(jax_state["state_dict"], tmp / "state.pt")
    return W.run_ranks(W.pair_job, 2, tmp / "ranks", str(tmp / "state.pt"))


# ---- (a) sync batch norm

def test_sync_batch_stats_match_shard_map_and_one_process(pair):
    feats, masks, weights = W.stats_inputs()

    def per_rank(f, m, w):
        def loss(f):
            mean, var = jstats(f, m, "data")
            return (mean * w[0, 0]).sum() + (var * w[0, 1]).sum(), (mean, var)

        (_, (mean, var)), g = jax.value_and_grad(loss, has_aux=True)(f)
        return mean, var, g

    fn = jax.jit(shard_map(per_rank, mesh=_mesh2(),
                           in_specs=(P("data"), P("data"), P("data")),
                           out_specs=(P(), P(), P("data")), check_vma=False))
    mean_j, var_j, g_j = fn(jnp.asarray(feats.reshape(4, 48, 6)),
                            jnp.asarray(masks.reshape(4, 48)), jnp.asarray(weights))
    g_j = np.asarray(g_j).reshape(feats.shape)
    # one process on the concatenated batch, the ranks' losses summed
    f1 = torch.from_numpy(feats.reshape(4, 48, 6)).requires_grad_(True)
    mean1, var1 = masked_batch_stats(f1, torch.from_numpy(masks.reshape(4, 48)))
    w = torch.from_numpy(weights)
    sum(((mean1 * w[r, 0]).sum() + (var1 * w[r, 1]).sum()) for r in range(2)).backward()
    g1 = f1.grad.numpy().reshape(feats.shape)
    tol = dict(rtol=1e-6, atol=1e-6)
    for r, out in enumerate(pair):
        for got, want_j, want_1 in ((out["mean"], mean_j, mean1),
                                    (out["var"], var_j, var1)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want_j), **tol)
            np.testing.assert_allclose(got.numpy(), want_1.detach().numpy(), **tol)
        np.testing.assert_allclose(out["grad"].numpy(), g_j[r], **tol)
        np.testing.assert_allclose(out["grad"].numpy(), g1[r], **tol)
    assert not np.any(pair[0]["grad"].numpy()[1])  # the empty event


# ---- (b) NT-Xent across ranks

def test_nt_xent_across_ranks_matches_shard_map(pair):
    z1, z2 = W.nt_xent_inputs()

    def per_rank(a, b):
        loss, (ga, gb) = jax.value_and_grad(
            lambda a, b: jnt_xent(a, b, 0.1, axis_name="data"), argnums=(0, 1))(a, b)
        return loss, ga, gb

    fn = jax.jit(shard_map(per_rank, mesh=_mesh2(), in_specs=(P("data"), P("data")),
                           out_specs=(P(), P("data"), P("data")), check_vma=False))
    loss_j, g1_j, g2_j = (np.asarray(x) for x in fn(jnp.asarray(z1), jnp.asarray(z2)))
    n = z1.shape[0] // 2
    for r, out in enumerate(pair):
        np.testing.assert_allclose(out["nt_loss"], float(loss_j), rtol=1e-5)
        for got, want in ((out["g1"], g1_j), (out["g2"], g2_j)):
            np.testing.assert_allclose(got.numpy(), want[r * n:(r + 1) * n],
                                       rtol=1e-4, atol=1e-7)


# ---- (c), (d) one supervised data-parallel step
#
# The step's gradients are compared where it hands them to the optimizer,
# after the mean across ranks, with the tolerance of the one-process step's
# test (test_torch_train_step.py): AdamW's first update moves an element
# whose true gradient is 0 by up to the learning rate for rounding noise,
# so the updated parameters say less about the step than its gradients.

def _jax_dp_step(jax_state):
    """JAX's data-parallel step on a 2-device mesh -> (its loss, the
    gradients its optimizer is given: make_loss_fn's, pmean'ed over the
    mesh, as make_train_step(axis_name=...) takes them)."""
    cfg = jax_state["cfg"]
    model = jbuild(cfg, axis_name="data")
    opt_cfg = cfg.mode.optimizer
    sched = jschedule(opt_cfg.lr_schedule, 4, 1)
    opt = jbuild_optimizer(opt_cfg, sched)
    params = jax.tree_util.tree_map(jnp.asarray, jax_state["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, jax_state["stats"])
    state = JTrainState(params, stats, opt.init(params), jnp.zeros((), jnp.int32))
    m2 = _mesh2()
    step = make_dp_train_step(
        jtrain_step(model, opt, JScheme.focal, sched, axis_name="data"), m2,
        n_batch_args=3)
    batch = jax_state["batch"]
    st = jbatch(batch["image"], W.GRID, capacity=512)
    labels = {k: jnp.asarray(batch[k]) for k in OUTPUT_SHAPE}
    st, labels = jax.device_put((st, labels), NamedSharding(m2, P("data")))
    rng = jax.random.PRNGKey(7)
    _, metrics = step(jax.device_put(state, NamedSharding(m2, P())), st, labels,
                      None, rng)
    loss_fn = make_loss_fn(model, JScheme.focal)

    def grads(params, stats, st, labels, rng):
        g = jax.grad(lambda p: loss_fn(p, stats, st, labels, None, rng, True)[0])(params)
        return jax.lax.pmean(g, "data")

    g = jax.jit(shard_map(grads, mesh=m2,
                          in_specs=(P(), P(), P("data"), P("data"), P()),
                          out_specs=P(), check_vma=False))(params, stats, st, labels, rng)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))
    return float(metrics["loss/loss"]), params_from_jax(to_np(g))


def _assert_gradients_close(got, want, rtol, rel_atol, floor_frac):
    """Each gradient within ``rtol`` and an atol of ``rel_atol`` of that
    tensor's largest |value|, but no less than ``floor_frac`` of the largest
    of all (a conv bias ahead of a batch norm has a true gradient of 0)."""
    assert set(got) == set(want) and got
    floor = floor_frac * max(float(w.abs().max()) for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=max(rel_atol * np.abs(w).max(), floor),
                                   err_msg=name)


def test_dp_step_matches_jax_make_dp_train_step(pair, jax_state):
    """Loss within rtol 1e-5; every mean gradient within rtol 1e-3 and an
    atol of 1e-4 of the tensor's largest |value| (floor 1e-5 of the
    largest); the two ranks' parameters after the update the same bits."""
    loss_j, grads_j = _jax_dp_step(jax_state)
    assert pair[0]["digest"] == pair[1]["digest"]
    for out in pair:
        np.testing.assert_allclose(out["metrics"]["loss/loss"], loss_j, rtol=1e-5)
        assert out["metrics"]["overflow/dropped"] == 0
        _assert_gradients_close(out["grads"], grads_j, 1e-3, 1e-4, 1e-5)


def test_dp_step_matches_one_process_step(pair, jax_state):
    """Two ranks of two events against one process on the four: loss rtol
    1e-5, mean gradients rtol 2e-4 and an atol of 1e-6 of the tensor's
    largest |value| (floor 1e-6 of the largest), the per-head accuracies
    the means of the ranks'."""
    metrics, _, grads = W.supervised_step(jax_state["state_dict"], jax_state["batch"],
                                          False)
    for out in pair:
        np.testing.assert_allclose(out["metrics"]["loss/loss"], metrics["loss/loss"],
                                   rtol=1e-5)
        _assert_gradients_close(out["grads"], grads, 2e-4, 1e-6, 1e-6)
        for k, v in metrics.items():
            if k.startswith("acc/"):
                assert out["metrics"][k] == pytest.approx(v)


# ---- (e) a group of one

def test_world_size_one_group_gives_the_bits_of_no_group(jax_state, tmp_path):
    torch.save(jax_state["state_dict"], tmp_path / "state.pt")
    (out,) = W.run_ranks(W.world1_job, 1, tmp_path / "ranks",
                         str(tmp_path / "state.pt"))
    group, none = out["group"], out["none"]
    assert group["metrics"] == none["metrics"]
    assert set(group["grads"]) == set(none["grads"]) and group["grads"]
    for name, g in group["grads"].items():
        assert torch.equal(g, none["grads"][name]), name
    for name, t in group["state"].items():  # parameters and running statistics
        assert torch.equal(t, none["state"][name]), name


# ---- (f) train and inference through the entry points

@pytest.fixture(scope="module")
def entry_points(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    out = W.run_ranks(W.entry_points_job, 2, tmp / "ranks", str(tmp / "out"))
    return tmp / "out", out


def test_dp_loaders_read_disjoint_shards(entry_points):
    _, (r0, r1) = entry_points
    for run_id in ("dp", "odd"):
        for a, b in zip(r0["shards"][run_id], r1["shards"][run_id]):
            assert a and b and not set(a) & set(b), run_id
    assert r0["shards"]["dp"][0] == [0, 1, 2, 3] and r1["shards"]["dp"][0] == [4, 5, 6, 7]


def test_dp_ranks_take_equal_step_counts_on_an_odd_split(entry_points):
    """Seven events: shards of 4 and 3 make epochs of 2 and 1 batches of 2;
    both ranks take the shorter one's count."""
    _, (r0, r1) = entry_points
    assert r0["shards"]["odd"][0] == [0, 1, 2, 3] and r1["shards"]["odd"][0] == [4, 5, 6]
    assert r0["odd_steps"] == r1["odd_steps"] == 1


def test_dp_only_rank_zero_writes_checkpoints(entry_points):
    out_dir, (r0, r1) = entry_points
    # dp to 2, resumed to 4, the odd split's 1 step, then each task's 2
    assert r0["writes"] == ["step_2.pt", "step_4.pt", "step_1.pt"] + ["step_2.pt"] * 4
    assert r1["writes"] == []
    index = out_dir / "synthetic" / "dp" / "checkpoints" / "checkpoint"
    assert index.read_text().splitlines()[0] == "latest: step_4.pt"


def test_dp_resume_restores_the_same_state_on_both_ranks(entry_points):
    _, (r0, r1) = entry_points
    assert r0["first"] == r1["first"] == (0, 2)
    assert r0["resumed"][:2] == r1["resumed"][:2] == (2, 2)
    assert r0["resumed"][2] == r1["resumed"][2]  # the same bits after two more steps


def test_dp_yolo_inference_writes_one_file_a_rank(entry_points):
    out_dir, (r0, r1) = entry_points
    assert r0["yolo"] == r1["yolo"] and np.isfinite(r0["yolo"]["loss/loss"])
    files = sorted(p.name for p in out_dir.glob("synthetic/yolo/validation_output/*"))
    assert files == ["val_rank_0.npz", "val_rank_1.npz"]
    for f in files:
        out = np.load(out_dir / "synthetic" / "yolo" / "validation_output" / f)
        assert out["vertex"].shape == (4, 3)  # two batches of 2 a rank


@pytest.mark.parametrize("task", TASKS)
def test_dp_trains_every_task_through_the_command_line(entry_points, task):
    """Two steps of each task through ``__main__.main`` on both ranks: the
    same finite loss (the mean across ranks), 0 dropped."""
    _, (r0, r1) = entry_points
    m0, m1 = r0["tasks"][task], r1["tasks"][task]
    assert m0["loss/loss"] == m1["loss/loss"] and np.isfinite(m0["loss/loss"])
    assert m0["overflow/dropped"] == m1["overflow/dropped"] == 0


def test_dp_softmax_file_equals_the_one_process_file(entry_points, tmp_path):
    out_dir, (r0, r1) = entry_points
    cfg = load_config("synthetic", W.TINY + [
        f"output_dir={tmp_path}", "run.id=soft", "data.synthetic_events=8",
        "mode=inference", f"mode.output_file={tmp_path}/softmax_one.npz"])
    torch.set_num_threads(1)
    one = validate(cfg)
    assert r0["softmax_metrics"] == r1["softmax_metrics"]
    for k in ("loss/loss", "overflow/dropped"):
        assert r0["softmax_metrics"][k] == pytest.approx(one[k], rel=1e-5)
    dp, single = np.load(out_dir / "softmax_dp.npz"), np.load(tmp_path / "softmax_one.npz")
    assert sorted(dp.files) == sorted(single.files) == sorted(OUTPUT_SHAPE)
    for k in OUTPUT_SHAPE:
        assert dp[k].shape == (8, OUTPUT_SHAPE[k])
        np.testing.assert_allclose(dp[k], single[k], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    return W.run_ranks(W.families_job, 2, tmp / "ranks", str(tmp / "out"))


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_dp_trains_and_serves_the_dense_and_point_cloud_families(families, family):
    """Two supervised steps and inference of each family under two ranks:
    the same finite losses and validation metrics and the same parameter
    bits on both (the gradients' mean is the same on both ranks).  The
    running statistics differ: each rank's batch norms take its own
    statistics, as the JAX family's norms, which have no ``axis_name``."""
    r0, r1 = (r[family] for r in families)
    assert len(r0["history"]) == len(r1["history"]) == 2
    for a, b in zip(r0["history"], r1["history"]):
        assert a["loss/loss"] == b["loss/loss"] and np.isfinite(a["loss/loss"])
        assert a["overflow/dropped"] == 0
    assert r0["validation"] == r1["validation"]
    assert np.isfinite(r0["validation"]["loss/loss"])
    assert len(r0["params"]) > 10
    for a, b in zip(r0["params"], r1["params"]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(r0["buffers"], r1["buffers"]))


# ---- (g) the bootstrap

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["no_env", "unreachable_store", "device_index"])
def test_bootstrap(case, monkeypatch, caplog):
    for v in mesh.ENV:
        monkeypatch.delenv(v, raising=False)
    cpu = load_config("synthetic", ["run.distributed=true", "run.compute_mode=CPU"])
    if case == "no_env":
        with caplog.at_level(logging.WARNING):
            dev = mesh.initialize_distributed(cpu)
        assert dev.type == "cpu" and not mesh.is_initialized()
        assert "continuing as one process" in caplog.text
        assert (mesh.rank(), mesh.world(), mesh.is_main()) == (0, 1, True)
    elif case == "unreachable_store":
        env = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            mesh.initialize_distributed(cpu, timeout=datetime.timedelta(seconds=2))
        assert time.monotonic() - t0 < 30 and not mesh.is_initialized()
    else:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        card = load_config("synthetic", ["run.distributed=true"])
        monkeypatch.setenv("LOCAL_RANK", "1")
        with pytest.raises(RuntimeError, match="cuda:1"):
            mesh.initialize_distributed(card)
        shared = load_config("synthetic", ["run.distributed=true",
                                           "framework.oversubscribe=2"])
        assert mesh.rank_device(shared) == torch.device("cuda", 0)
        assert mesh.backend_for(card, torch.device("cuda", 0)) == "nccl"
        assert mesh.backend_for(shared, torch.device("cuda", 0)) == "gloo"
        assert mesh.backend_for(cpu, torch.device("cpu")) == "gloo"
