"""``framework.remat`` in the port: each block series of the encoder runs
under ``torch.utils.checkpoint`` in training, as JAX wraps it in
``nn.remat``.  With it on and off, one backward from the same weights on
the same batch gives the same bits in every gradient and every running
statistic (the recomputation leaves the statistics alone); under remat
each series' forward runs twice, once more in the backward; the SimCLR
and vertex models' encoders honour the key too.  The JAX package with
remat on is held against the port with remat on."""

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
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.train.supervised import make_loss_fn
from sparseeventid_tpu_torch.config import load_config
from sparseeventid_tpu_torch.config import schema as tschema
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_2d
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch
from sparseeventid_tpu_torch.models import SparseBlockSeries, build_sparse_classifier
from sparseeventid_tpu_torch.models import init_parameters
from sparseeventid_tpu_torch.train.losses import multi_head_loss
from sparseeventid_tpu_torch.train.tasks import build_task

GRID = (16, 16, 16)
SMALL = ["data=synthetic", "encoder.depth=2", "encoder.blocks_per_layer=2",
         "encoder.n_initial_filters=8", "encoder.n_output_filters=8",
         "framework.min_capacity=64", "head.dropout=0.0", "head.hidden=16",
         "run.compute_mode=CPU", "data.max_voxels=256", "run.minibatch_size=2"]


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(*extra):
    return load_config("synthetic", SMALL + list(extra))


@pytest.fixture(scope="module")
def batch():
    ds = SyntheticDataset(4, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    return ds.batch([0, 1])


def _count_series_forwards(model):
    counts = {}

    def hook(name):
        def pre(mod, args):
            counts[name] = counts.get(name, 0) + 1
        return pre

    for name, mod in model.named_modules():
        if isinstance(mod, SparseBlockSeries):
            mod.register_forward_pre_hook(hook(name))
    return counts


def _step(cfg, batch, image_to_st, grid, cap):
    """One supervised forward and backward from seed-0 weights -> (loss,
    gradients, buffers, series forward counts)."""
    model = init_parameters(build_sparse_classifier(cfg), 0).train()
    counts = _count_series_forwards(model)
    st = image_to_st(batch["image"], grid, capacity=cap)
    logits, dropped = model(st)
    assert int(dropped) == 0
    loss, _ = multi_head_loss(logits, {k: torch.from_numpy(batch[k])
                                       for k in OUTPUT_SHAPE},
                              tschema.LossBalanceScheme.focal)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return loss.detach(), grads, buffers, counts


@pytest.mark.parametrize("dimension", [3, 2])
@pytest.mark.parametrize("backend", ["window", "xla"])
def test_remat_gives_the_same_bits_and_recomputes_each_series(
        backend, dimension, batch, one_torch_thread):
    """Loss, every gradient and every running statistic bit-equal with
    remat on and off; 2 forwards of each encoder series under remat (the
    forward and the backward's recomputation) and 1 without; the
    per-label series of a 2D model are not recomputed (JAX does not wrap
    them)."""
    extra = [f"framework.sparse_backend={backend}"]
    grid, cap, to_st, b = GRID, 512, tbatch, batch
    if dimension == 2:
        extra += ["data.dimension=2", "data.images=3",
                  "encoder.per_label_final_series=true"]
        grid, cap, to_st = (3, 32, 32), 1024, larcv_batch_to_sparse_2d
        b = SyntheticDataset(4, SyntheticEventConfig(
            image_size=(32, 32, 32), n_planes=3, max_voxels=256), seed=5
        ).batch([0, 1])
    on = _step(_cfg(*extra, "framework.remat=true"), b, to_st, grid, cap)
    off = _step(_cfg(*extra, "framework.remat=false"), b, to_st, grid, cap)
    assert torch.equal(on[0], off[0])
    assert set(on[1]) == set(off[1]) and len(on[1]) > 20
    for name in on[1]:
        assert torch.equal(on[1][name], off[1][name]), name
    assert any(float(g.abs().max()) > 0 for g in on[1].values())
    for name in on[2]:
        assert torch.equal(on[2][name], off[2][name]), name
    moved = [n for n in on[2] if n.endswith(".mean")
             and float(on[2][n].abs().max()) > 0]
    assert len(moved) > 10
    encoder = {n for n in on[3] if n.startswith("encoder.")}
    assert encoder == {"encoder.series_0", "encoder.series_1",
                       "encoder.final_series"}
    for name in on[3]:
        assert on[3][name] == (2 if name in encoder else 1), name
        assert off[3][name] == 1, name


def test_remat_on_matches_jax_remat_on(batch, one_torch_thread):
    """The JAX model with ``nn.remat`` series (its plain backend) against
    the port with checkpointed series: loss and gradients within
    test_torch_train_step.py's tolerance, the running statistics within
    1e-5 (each moved once)."""
    ov = SMALL[:-3] + ["framework.remat=true", "framework.sparse_backend=xla"]
    cfg_j = jload("synthetic", ov)
    cfg_j = dataclasses.replace(cfg_j, data=dataclasses.replace(cfg_j.data,
                                                                max_voxels=256))
    sj = jbatch(batch["image"], GRID, capacity=512)
    v = jbuild(cfg_j).init(jax.random.PRNGKey(0), sj, True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(t))
    params, stats = to_np(v["params"]), to_np(v["batch_stats"])
    lj = {k: jnp.asarray(batch[k]) for k in OUTPUT_SHAPE}
    (loss_j, (_, new_stats, _, _)), grads_j = jax.value_and_grad(
        make_loss_fn(jbuild(cfg_j), JScheme.focal), has_aux=True)(
        params, stats, sj, lj, None, jax.random.PRNGKey(1), True)
    want = params_from_jax(to_np(grads_j), to_np(new_stats))

    model = build_sparse_classifier(_cfg("framework.remat=true",
                                         "framework.sparse_backend=window"))
    assert model.encoder.remat
    model.load_state_dict(params_from_jax(params, stats))
    logits, _ = model.train()(tbatch(batch["image"], GRID, capacity=512))
    loss, _ = multi_head_loss(logits, {k: torch.from_numpy(batch[k])
                                       for k in OUTPUT_SHAPE},
                              tschema.LossBalanceScheme.focal)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=max(1e-4 * np.abs(g).max(), floor),
                                   err_msg=name)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("task", ["simclr", "yolo"])
def test_task_encoders_honour_remat(task, tmp_path, one_torch_thread):
    """The SimCLR and vertex models take ``framework.remat`` into their
    encoder: one backward of the task's outputs gives the same bits on and
    off, and each encoder series runs twice under remat (SimCLR: twice a
    view)."""
    results = {}
    for remat in ("true", "false"):
        cfg = _cfg(f"name={task}", f"framework.remat={remat}",
                   "framework.sparse_backend=xla", f"output_dir={tmp_path}",
                   "data.transform1=true", "data.transform2=true")
        ds = SyntheticDataset(4, SyntheticEventConfig(image_size=GRID,
                                                      max_voxels=256), seed=3)
        t = build_task(cfg, ds, GRID, 2, None, torch.device("cpu"))
        model = t.state.model.train()
        assert model.encoder.remat == (remat == "true")
        counts = _count_series_forwards(model)
        args = t.prepare(ds.batch([0, 1]))
        out = model(*args[:2]) if task == "simclr" else model(args[0])
        sum(o.float().sum() for o in out[:2]).backward()
        results[remat] = ({n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}, counts)
    on, off = results["true"], results["false"]
    assert set(on[0]) == set(off[0]) and len(on[0]) > 10
    for name in on[0]:
        assert torch.equal(on[0][name], off[0][name]), name
    per_forward = 2 if task == "simclr" else 1
    assert set(on[1].values()) == {2 * per_forward}
    assert set(off[1].values()) == {per_forward}
