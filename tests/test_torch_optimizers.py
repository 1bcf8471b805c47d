"""The port's eight optimizers against optax 0.2.6 as the JAX package builds
them (``sparseeventid_tpu/train/optimizers.py``), and its analysis helpers
against the JAX package's copy.

The parameters are a flax-named tree with a 3x3x3 ``nn.Conv`` kernel, its
bias, a ``Dense`` kernel and a sparse conv weight; the port's tensors come
from ``convert.params_from_jax`` (permuted and transposed), so the
comparison also holds the converter's layout."""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from sparseeventid_tpu.train.schedules import build_lr_schedule as jschedule
from sparseeventid_tpu.utils import analysis as janalysis
from sparseeventid_tpu.utils.checkpoint import encoder_freeze_mask
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.train import TrainState, build_lr_schedule, build_optimizer
from sparseeventid_tpu_torch.utils import analysis as tanalysis

KINDS = ["adam", "rmsprop", "sgd", "adagrad", "adadelta", "lars", "lamb",
         "novograd"]
SHAPES = {
    "encoder": {"initial_w": (27, 1, 4)},
    "head": {"conv1": {"kernel": (3, 3, 3, 4, 5), "bias": (5,)},
             "event_out": {"kernel": (5, 3), "bias": (3,)}},
}
EPOCH, EPOCHS = 4, 8  # the warm-up schedule's first steps


def _tree(rng, shapes):
    return {k: _tree(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _jnp(tree):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _overrides(kind, extra=()):
    return [f"mode.optimizer.name={kind}", "mode.optimizer.lr_schedule=standard",
            "mode.optimizer.weight_decay=0.01", *extra]


def _run(kind, n_steps=3, extra=(), transfer=False):
    """n_steps updates of the same parameters and gradients through optax
    and through the port -> (optax's parameters as a state_dict, the port's,
    the initial ones)."""
    rng = np.random.default_rng(KINDS.index(kind))
    p0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(n_steps)]
    cj = jload("synthetic", _overrides(kind, extra)).mode.optimizer
    ct = tload("synthetic", _overrides(kind, extra)).mode.optimizer
    opt_j = jbuild_optimizer(cj, jschedule(cj.lr_schedule, EPOCH, EPOCHS))
    if transfer:
        opt_j = optax.multi_transform(
            {"trainable": opt_j, "frozen": optax.set_to_zero()},
            encoder_freeze_mask)
    pj = _jnp(p0)
    state_j = opt_j.init(pj)
    for g in grads:
        updates, state_j = opt_j.update(_jnp(g), state_j, pj)
        pj = optax.apply_updates(pj, updates)

    params = {n: torch.nn.Parameter(t) for n, t in params_from_jax(p0).items()}
    model = torch.nn.Module()
    for n, p in params.items():
        model.register_parameter(n.replace(".", "_"), p)
    trainable = [n for n in params
                 if not (transfer and n.startswith("encoder."))]
    opt, sched = build_optimizer(ct, build_lr_schedule(ct.lr_schedule, EPOCH, EPOCHS),
                                 [params[n] for n in trainable])
    state = TrainState(model, opt, sched)
    for g in grads:
        for n, t in params_from_jax(g).items():
            if n in trainable:
                params[n].grad = (t if params[n].grad is None
                                  else params[n].grad + t)
        state.apply_gradients(ct.gradient_accumulation)
    # the port keeps gradients summed until the update: hand back none
    assert all(p.grad is None for p in params.values())
    want = params_from_jax(_np(pj))
    got = {n: p.detach() for n, p in params.items()}
    return want, got, params_from_jax(p0), state


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_match(want, got, start):
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_three_updates_match_optax(kind):
    """Three updates under the warm-up schedule with weight decay 0.01
    (taken by adam, lars, lamb and novograd, as the JAX factory passes it):
    every parameter within rtol 1e-5 of optax's, and every one moved."""
    want, got, start, state = _run(kind)
    _assert_match(want, got, start)
    for name in want:
        assert not torch.equal(got[name], start[name]), name
    assert state.step == 3 and state.scheduler.last_epoch == 3


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_accumulation_matches_multisteps(kind):
    """gradient_accumulation=2 is ``optax.MultiSteps``: four micro-steps
    give two updates with the mean of each pair of gradients."""
    want, got, start, state = _run(
        kind, n_steps=4, extra=["mode.optimizer.gradient_accumulation=2"])
    _assert_match(want, got, start)
    assert state.step == 4 and state.scheduler.last_epoch == 2


def test_lamb_transfer_run_keeps_the_frozen_encoder():
    """A transfer run (the JAX ``multi_transform`` with ``set_to_zero`` on
    the encoder): LAMB's per-tensor trust ratios leave the encoder exactly
    where it was and move the head as optax does."""
    want, got, start, _ = _run("lamb", transfer=True)
    _assert_match(want, got, start)
    assert torch.equal(got["encoder.initial_w"], start["encoder.initial_w"])
    assert not torch.equal(got["head.conv1.weight"], start["head.conv1.weight"])


def test_optimizer_state_round_trips_through_state_dict():
    """The hand-written rules keep their state as tensors: a fresh optimizer
    loaded from a saved state_dict (``torch.save``, read back with
    ``weights_only=True`` as checkpoints are) takes the same next step."""
    for kind in ("lamb", "novograd", "adadelta"):
        ct = tload("synthetic", _overrides(kind)).mode.optimizer
        sched_fn = build_lr_schedule(ct.lr_schedule, EPOCH, EPOCHS)
        a = torch.nn.Parameter(torch.linspace(-1, 1, 12).reshape(3, 4))
        opt, sched = build_optimizer(ct, sched_fn, [a])
        g = torch.linspace(0.5, -0.5, 12).reshape(3, 4)
        for _ in range(2):
            a.grad = g.clone()
            opt.step()
            sched.step()
        b = torch.nn.Parameter(a.detach().clone())
        opt_b, sched_b = build_optimizer(ct, sched_fn, [b])
        buf = io.BytesIO()
        torch.save(opt.state_dict(), buf)
        buf.seek(0)
        opt_b.load_state_dict(torch.load(buf, weights_only=True))
        sched_b.load_state_dict(sched.state_dict())
        for p, o, s in ((a, opt, sched), (b, opt_b, sched_b)):
            p.grad = g.clone()
            o.step()
            s.step()
        assert torch.equal(a, b), kind


def test_analysis_matches_jax_copy():
    """utils/analysis.py: the port's copy gives the JAX package's numbers on
    random predictions."""
    rng = np.random.default_rng(4)
    labels = {"labelneutID": rng.integers(0, 3, 200),
              "labelnpiID": rng.integers(0, 2, 200)}
    scores = {k: rng.random((200, 3 if k == "labelneutID" else 2))
              for k in labels}
    for k, lab in labels.items():
        pred = scores[k].argmax(-1)
        n = scores[k].shape[1]
        np.testing.assert_array_equal(tanalysis.confusion_matrix(lab, pred, n),
                                      janalysis.confusion_matrix(lab, pred, n))
        for a, b in zip(tanalysis.roc_curve(lab, scores[k]),
                        janalysis.roc_curve(lab, scores[k])):
            np.testing.assert_array_equal(a, b)
    got = tanalysis.summarize_predictions(scores, labels)
    want = janalysis.summarize_predictions(scores, labels)
    for k in labels:
        for stat in ("efficiency", "purity", "confusion"):
            np.testing.assert_array_equal(got[k][stat], want[k][stat])
        assert got[k]["auc"] == want[k]["auc"]
        assert got[k]["accuracy"] == want[k]["accuracy"]
    fpr, tpr, _ = tanalysis.roc_curve(labels["labelnpiID"], scores["labelnpiID"])
    assert tanalysis.auc(fpr, tpr) == janalysis.auc(fpr, tpr)
