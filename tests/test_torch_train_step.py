"""The port's train step against the JAX package's, module by module and as
a whole, at fp32 on the CPU: masked batch norm in train mode, the learning
rate schedules, one AdamW update, and the supervised step of a depth-2
model from the same initial state (same numpy inputs through both).  The
whole-model cases run the JAX model on its plain ``xla`` backend and the
port on both of its backends."""

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
from sparseeventid_tpu.models.blocks import MaskedBatchNorm as JBatchNorm
from sparseeventid_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from sparseeventid_tpu.train.schedules import build_lr_schedule as jschedule
from sparseeventid_tpu.train.state import TrainState as JTrainState
from sparseeventid_tpu.train.supervised import make_loss_fn, make_train_step as jtrain_step
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config import schema as tschema
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.models.blocks import MaskedBatchNorm
from sparseeventid_tpu_torch.models.heads import dropout
from sparseeventid_tpu_torch.train import (
    TrainState,
    build_lr_schedule,
    build_optimizer,
    make_train_step,
    param_count,
)


# ---- (c) masked batch norm in train mode

def test_masked_batch_norm_train_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32) * 2.0 + 0.5
    mask = np.zeros((2, 40), bool)
    mask[0, :33] = True
    mask[1, :17] = True
    x = x * mask[..., None]
    gy = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    mod = JBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {k: jnp.asarray(v) for k, v in stats.items()}}

    def f(xj):
        out, mutated = mod.apply(variables, xj, jnp.asarray(mask), True,
                                 mutable=["batch_stats"])
        return jnp.sum(out * gy), (out, mutated["batch_stats"])

    (_, (out_j, stats_j)), gx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    bn = MaskedBatchNorm(6).train()
    bn.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "mean": torch.from_numpy(stats["mean"]),
                        "var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn(xt, torch.from_numpy(mask))
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)
    for k in ("mean", "var"):  # momentum 0.9 running averages
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(stats_j[k]),
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(getattr(bn, k).numpy(), stats[k])
    bn.eval()  # eval mode leaves the statistics alone
    before = bn.mean.clone()
    bn(xt.detach(), torch.from_numpy(mask))
    assert torch.equal(bn.mean, before)


# ---- (d) schedules and the optimizer

SCHEDULES = [
    ("standard", ["mode.optimizer.lr_schedule=standard"], 7, 12),
    ("standard_short", ["mode.optimizer.lr_schedule=standard",
                        "mode.optimizer.lr_schedule.decay_epochs=1"], 5, 3),
    ("one_cycle", ["mode.optimizer.lr_schedule=one_cycle",
                   "mode.optimizer.lr_schedule.peak_learning_rate=0.01"], 9, 20),
    ("flat", ["mode.optimizer.lr_schedule=flat"], 4, 2),
]


@pytest.mark.parametrize("name,overrides,epoch_length,total_epochs", SCHEDULES)
def test_lr_schedule_matches_jax(name, overrides, epoch_length, total_epochs):
    cj = jload("synthetic", overrides).mode.optimizer.lr_schedule
    ct = tload("synthetic", overrides).mode.optimizer.lr_schedule
    want = jschedule(cj, epoch_length, total_epochs)
    got = build_lr_schedule(ct, epoch_length, total_epochs)
    last = epoch_length * total_epochs
    steps = sorted(set(range(0, last + 3)) | {last + 50})
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6,
        atol=1e-12)
    assert got(last + 50) == (0.0 if name != "flat" else got(0))


def test_adamw_updates_match_optax():
    """Three AdamW updates under a warm-up schedule and weight decay: the
    parameters follow optax.adamw (rtol 1e-6; float32 both sides)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    ov = ["mode.optimizer.lr_schedule=standard", "mode.optimizer.weight_decay=0.01"]
    cj, ct = jload("synthetic", ov).mode.optimizer, tload("synthetic", ov).mode.optimizer
    opt_j = jbuild_optimizer(cj, jschedule(cj.lr_schedule, 4, 8))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt_j.init(pj)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt_t, sched = build_optimizer(ct, build_lr_schedule(ct.lr_schedule, 4, 8),
                                   params.values())
    for g in grads:
        updates, state = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                      state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt_t.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-7)
        assert not np.allclose(params[k].detach().numpy(), p0[k])


@pytest.mark.parametrize("scheme", ["focal", "even", "none"])
def test_loss_gradients_match_jax(scheme):
    """multi_head_loss under autograd: value and d loss / d logits of each
    balance scheme (class weights on the two-class heads for ``even``)."""
    from sparseeventid_tpu.train.losses import multi_head_loss as jloss
    from sparseeventid_tpu_torch.train.losses import multi_head_loss as tloss

    rng = np.random.default_rng(7)
    logits = {k: rng.standard_normal((6, n)).astype(np.float32) * 2
              for k, n in OUTPUT_SHAPE.items()}
    labels = {k: rng.integers(0, n, 6).astype(np.int32)
              for k, n in OUTPUT_SHAPE.items()}
    wj = wt = None
    if scheme == "even":
        wj = {k: jnp.asarray([0.582, 1.417]) for k, n in OUTPUT_SHAPE.items() if n == 2}
        wt = {k: torch.tensor([0.582, 1.417]) for k, n in OUTPUT_SHAPE.items() if n == 2}
    lj = {k: jnp.asarray(v) for k, v in labels.items()}
    want, grads_j = jax.value_and_grad(
        lambda lg: jloss(lg, lj, JScheme[scheme], wj)[0]
    )({k: jnp.asarray(v) for k, v in logits.items()})
    lt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in logits.items()}
    got, _ = tloss(lt, {k: torch.from_numpy(v) for k, v in labels.items()},
                   tschema.LossBalanceScheme[scheme], wt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(lt[k].grad.numpy(), np.asarray(grads_j[k]),
                                   rtol=1e-4, atol=1e-6)


def test_other_optimizers_name_the_roadmap():
    """The other seven kinds are built now (their updates are held against
    optax in test_torch_optimizers.py); each sits under the schedule's
    LambdaLR at base lr 1.0, as AdamW does."""
    for kind in ("rmsprop", "sgd", "adagrad", "adadelta", "lars", "lamb",
                 "novograd"):
        cfg = tload("synthetic", [f"mode.optimizer.name={kind}"]).mode.optimizer
        opt, sched = build_optimizer(cfg, lambda s: 0.5,
                                     [torch.nn.Parameter(torch.zeros(1))])
        assert opt.kind == kind and opt.param_groups[0]["lr"] == 0.5
        assert sched.base_lrs == [1.0]


def test_dropout_draws_from_its_generator():
    x = torch.ones((64, 32))
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    c = dropout(x, 0.5, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.35 < float((a == 0).float().mean()) < 0.65
    assert dropout(x, 0.5, False) is x and dropout(x, 0.0, True) is x


# ---- (e) the whole train step: a depth-2 model from the same state

GRID = (16, 16, 16)
OVERRIDES = [
    "data=synthetic", "encoder.depth=2", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=16", "encoder.n_output_filters=16",
    "run.minibatch_size=2", "framework.min_capacity=64", "head.dropout=0.0",
    "head.hidden=32", "mode.optimizer.lr_schedule=flat",
    "mode.optimizer.lr_schedule.peak_learning_rate=0.003",
]


def _cfgs(backend):
    ov = OVERRIDES + [f"framework.sparse_backend={backend}"]
    out = []
    for load in (jload, tload):
        cfg = load("synthetic", ov)
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_voxels=256)))
    return out


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    batches = [ds.batch([2 * i, 2 * i + 1]) for i in range(3)]
    cfg_j, _ = _cfgs("xla")
    variables = jbuild(cfg_j).init(
        jax.random.PRNGKey(0), jbatch(batches[0]["image"], GRID, capacity=512), True)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))
    return dict(batches=batches, params=to_np(variables["params"]),
                stats=to_np(variables["batch_stats"]))


def _jax_side(setup):
    """The JAX model on its plain ``xla`` backend: the same function as its
    window backend (the conv-level tests hold the port against that one in
    interpret mode; a whole model's backward there takes minutes)."""
    cfg_j, _ = _cfgs("xla")
    model = jbuild(cfg_j)
    opt_cfg = cfg_j.mode.optimizer
    sched = jschedule(opt_cfg.lr_schedule, 4, 1)
    opt = jbuild_optimizer(opt_cfg, sched)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, setup["stats"])
    state = JTrainState(params, stats, opt.init(params), jnp.zeros((), jnp.int32))
    return model, opt, sched, state


def _torch_side(backend, setup):
    _, cfg_t = _cfgs(backend)
    model = tbuild(cfg_t)
    model.load_state_dict(params_from_jax(setup["params"], setup["stats"]))
    opt_cfg = cfg_t.mode.optimizer
    sched = build_lr_schedule(opt_cfg.lr_schedule, 4, 1)
    optimizer, scheduler = build_optimizer(opt_cfg, sched, model.parameters())
    state = TrainState(model, optimizer, scheduler)
    scheme = tschema.LossBalanceScheme.focal
    return state, make_train_step(state, scheme, sched), sched


def _inputs(batch):
    sj = jbatch(batch["image"], GRID, capacity=512)
    st = tbatch(batch["image"], GRID, capacity=512)
    lj = {k: jnp.asarray(batch[k]) for k in OUTPUT_SHAPE}
    lt = {k: torch.from_numpy(batch[k]) for k in OUTPUT_SHAPE}
    return sj, st, lj, lt


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_step0_loss_and_gradients_match_jax(backend, setup):
    """Loss within rtol 1e-5; every parameter gradient within rtol 1e-3 and
    an atol of 1e-4 of that tensor's largest |gradient| (float32 sums in
    another order; batch norm divides small differences by small
    deviations), but no less than 1e-5 of the largest gradient of any
    parameter: a conv bias ahead of a batch norm has a true gradient of 0
    and both sides return rounding noise.  The running statistics after the
    step within 1e-5."""
    model_j, _, _, state_j = _jax_side(setup)
    sj, st, lj, lt = _inputs(setup["batches"][0])
    loss_fn = make_loss_fn(model_j, JScheme.focal)
    (loss_j, (_, new_stats, _, dropped_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(state_j.params, state_j.batch_stats, sj, lj,
                               None, jax.random.PRNGKey(1), True)
    assert int(dropped_j) == 0
    want = params_from_jax(
        jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(grads_j)),
        jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(new_stats)))

    state, _, _ = _torch_side(backend, setup)
    model = state.model.train()
    assert param_count(model) == sum(
        x.size for x in jax.tree_util.tree_leaves(setup["params"]))
    logits, dropped = model(st)
    from sparseeventid_tpu_torch.train.losses import multi_head_loss

    loss, _ = multi_head_loss(logits, lt, tschema.LossBalanceScheme.focal)
    loss.backward()
    assert int(dropped) == 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    named = dict(model.named_parameters())
    assert len(named) + len(dict(model.named_buffers())) == len(want)
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=1e-3,
            atol=max(1e-4 * np.abs(g).max(), floor), err_msg=name)
    assert any(np.abs(want[n].numpy()).max() > 0 for n in named if n.endswith(".w"))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_three_train_steps_follow_jax(backend, setup):
    """Three steps on three batches from the same state: every metric of every step within rtol 1e-3 of the JAX step's (the
    second and third losses pass through two AdamW updates of float32
    gradients that agree to about 1e-4), 0 dropped pairs."""
    model_j, opt, sched_j, state_j = _jax_side(setup)
    step_j = jax.jit(jtrain_step(model_j, opt, JScheme.focal, sched_j))
    state, step, _ = _torch_side(backend, setup)
    rng = jax.random.PRNGKey(5)
    for i, batch in enumerate(setup["batches"]):
        sj, st, lj, lt = _inputs(batch)
        state_j, mj = step_j(state_j, sj, lj, None, rng)
        mt = step(st, lt, torch.Generator().manual_seed(5))
        assert set(mt) == set(mj)
        assert int(mt["overflow/dropped"]) == 0 == int(mj["overflow/dropped"])
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert state.step == 3 == int(state_j.step)
    assert all(p.grad is None for p in state.model.parameters())


def test_gradient_accumulation_averages_two_steps(setup):
    """k = 2: no update after the first step; the second applies the mean
    of the two gradients.  With the same batch twice that mean is the
    batch's own gradient, so the parameters equal one plain step's."""
    _, st, _, lt = _inputs(setup["batches"][0])
    plain_state, plain_step, sched = _torch_side("xla", setup)
    plain_step(st, lt)
    state, _, _ = _torch_side("xla", setup)
    step = make_train_step(state, tschema.LossBalanceScheme.focal, sched,
                           gradient_accumulation=2)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step(st, lt)
    assert all(torch.equal(p, before[n]) for n, p in state.model.named_parameters())
    assert state.scheduler.last_epoch == 0
    step(st, lt)
    assert state.scheduler.last_epoch == 1 and state.step == 2
    want = dict(plain_state.model.named_parameters())
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p, want[n], rtol=1e-6, atol=1e-8)
    assert any(not torch.equal(p, before[n])
               for n, p in state.model.named_parameters())
