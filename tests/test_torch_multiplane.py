"""The 2D multiplane slice of the port against the JAX package: the 2D
input transform, query meta and window plans on a 3-plane grid (kernels
[1,3,3], [1,5,5], [3,3,3], stride (1,2,2)), the depth-2 multiplane
classifier on both backends with and without the cross-plane merge, one
train step, and the command line on the CPU."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, random_coo

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset as JDataset
from sparseeventid_tpu.io import SyntheticEventConfig as JEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_2d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.models.encoder import encoder_output_shape as jshape
from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
from sparseeventid_tpu.ops.rulebook import kernel_offsets
from sparseeventid_tpu.train.optimizers import build_optimizer as jbuild_optimizer
from sparseeventid_tpu.train.schedules import build_lr_schedule as jschedule
from sparseeventid_tpu.train.state import TrainState as JTrainState
from sparseeventid_tpu.train.supervised import make_train_step as jtrain_step
from sparseeventid_tpu_torch.__main__ import main as cli
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config import schema as tschema
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_2d as tbatch
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.models import encoder_output_shape, init_parameters
from sparseeventid_tpu_torch.ops import engine as teng
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import engine as twe
from sparseeventid_tpu_torch.ops.window import query as tq
from sparseeventid_tpu_torch.train import (
    TrainState,
    build_lr_schedule,
    build_optimizer,
    make_train_step,
)
from sparseeventid_tpu_torch.train.evaluate import (
    build_dataset,
    prepare_batch,
)

GRID = (3, 32, 32)  # plane axis first
CAP = 1024
PLAN_FIELDS = ("qmeta", "start", "q_active", "ov_src", "ov_dst", "ov_k",
               "ov_valid", "ov_dropped")


def _plane_pair(seed=0, c=4, n_live=(700, 260)):
    coords, feats = random_coo(seed, b=2, n=CAP, grid=GRID, c=c, density=0.3,
                               n_live=list(n_live))
    return both(coords, feats, GRID)


def _assert_plans_equal(pt, pj):
    for f in PLAN_FIELDS:
        assert_equal(getattr(pt, f), getattr(pj, f))
    assert (pt.offsets, pt.dkeys, pt.window_r) == (pj.offsets, pj.dkeys, pj.window_r)


# ---- the input transform and the synthetic 2D dataset

def test_larcv_batch_to_sparse_2d_equals_jax():
    cfg = dict(image_size=(32, 32, 32), n_planes=3, max_voxels=256)
    batch = JDataset(4, JEventConfig(**cfg), seed=3).batch([0, 1])
    mine = SyntheticDataset(4, SyntheticEventConfig(**cfg), seed=3).batch([0, 1])
    np.testing.assert_array_equal(mine["image"], batch["image"])
    assert batch["image"].shape == (2, 3, 256, 3)
    # a pixel outside the declared grid is dropped, as in the JAX transform
    image = batch["image"].copy()
    image[0, 1, 0, :2] = (40.0, 3.0)
    sj = jbatch(image, GRID, capacity=CAP)
    st = tbatch(image, GRID, capacity=CAP)
    assert_equal(st.coords, sj.coords)
    assert_equal(st.feats, sj.feats)
    assert_equal(st.n_active, sj.n_active)
    assert st.grid_shape == GRID and int(st.n_active.min()) > 100
    assert set(st.coords[0, : int(st.n_active[0]), 0].tolist()) == {0, 1, 2}
    st2, labels = prepare_batch(dict(batch, image=image), GRID, CAP,
                                torch.float32, torch.device("cpu"))
    assert torch.equal(st2.coords, st.coords) and set(labels) == set(OUTPUT_SHAPE)


def test_synthetic_2d_dataset_is_built_as_the_jax_trainer_builds_it():
    """3D tracks on (H, H, W) projected per plane, seeded by split name and
    run seed (sparseeventid_tpu/train/trainer.py, ``_build_datasets``)."""
    import zlib

    ov = ["data.dimension=2", "data.images=3", "data.synthetic_events=4"]
    cfg_j, cfg_t = jload("synthetic", ov), tload("synthetic", ov)
    want = JDataset(
        4, JEventConfig(image_size=(64, 64, 64), n_planes=3,
                        max_voxels=cfg_j.data.max_voxels,
                        normalize=cfg_j.data.normalize),
        seed=(zlib.crc32(b"train") + cfg_j.run.seed) % 2**31,
    ).batch([1])
    ds = build_dataset(cfg_t, "train")
    assert ds.cfg.n_planes == 3 and ds.image_size() == (64, 64, 64)
    assert ds.batch_grid() == (3, 64, 64)
    np.testing.assert_array_equal(ds.batch([1])["image"], want["image"])
    assert want["image"].shape == (1, 3, 2048, 3)


def test_encoder_output_shape_matches_jax():
    for dim, shape in ((2, (3, 1536, 1024)), (3, (1024, 512, 1280))):
        cj, ct = jload("synthetic").encoder, tload("synthetic").encoder
        assert encoder_output_shape(ct, shape, dim) == jshape(cj, shape, dim)


# ---- query meta and plans on the 3-plane grid

@pytest.mark.parametrize("ksz", [(1, 3, 3), (1, 5, 5), (3, 3, 3)])
def test_plane_query_meta_and_series_plan_bit_equal(ksz):
    """Cross-plane offsets of [3,k,k] are invalid at the edge planes
    (validity bits); keys of different planes are far apart in the sorted
    table, so windows straddle plane boundaries."""
    sj, st = _plane_pair()
    offs = kernel_offsets(ksz, centered=True)
    mt = tq.compute_query_meta(st, offs)
    assert_equal(mt, jwc.compute_query_meta(sj, offs))
    dk = tq.key_deltas(GRID, offs)
    assert dk == jwc.key_deltas(GRID, offs)
    assert_equal(tq.materialize_qkeys(mt, dk),
                 np.asarray(jwc.compute_query_keys(sj, offs)).transpose(0, 2, 1))
    assert_equal(tq.compute_query_keys(st, offs), jwc.compute_query_keys(sj, offs))
    r = 176 if ksz == (1, 5, 5) else 160
    cap = teng.device_list_width(st.capacity)
    pj = jwe.build_submanifold_window_plan(sj, ksz, overflow_cap=cap,
                                           interpret=True, window_r=r)
    pt = teng.build_series_plan(st, ksz, backend=teng.WINDOW, window_r=r)
    _assert_plans_equal(pt, pj)
    assert int(pt.ov_dropped.sum()) == 0


def test_plane_strided_meta_and_plans_bit_equal():
    """Stride (1,2,2): K = 4, the plane axis is not strided; the reverse
    meta packs the intra-cell offset id into one word."""
    stride = (1, 2, 2)
    sj, st = _plane_pair(seed=1)
    skj = jds(sj, stride, 512)
    skt = trb.downsample_sites(st, stride, 512)
    assert skt.grid_shape == (3, 16, 16) == skj.grid_shape
    assert_equal(skt.coords, skj.coords)
    offs = kernel_offsets(stride, centered=False)
    assert len(offs) == 4
    assert_equal(
        tq.compute_strided_query_meta(skt, GRID, stride, offs),
        jwc.compute_strided_query_meta(skj, GRID, stride, offs))
    assert_equal(tq.compute_reverse_query_meta(st, skt, stride, 4),
                 jwc.compute_reverse_query_meta(sj, skj, stride, 4))
    cap = teng.device_list_width(st.capacity)
    fj, rj = jwe.build_strided_window_plans(sj, skj, stride, overflow_cap=cap,
                                            interpret=True)
    sk2, (ft, rt), dropped = teng.build_downsample_plan(
        st, stride, 512, backend=teng.WINDOW)
    assert int(dropped.sum()) == 0 and torch.equal(sk2.coords, skt.coords)
    _assert_plans_equal(ft, fj)
    _assert_plans_equal(rt, rj)


@pytest.mark.parametrize("ksz,c", [((1, 5, 5), 1), ((3, 3, 3), 4)])
def test_plane_window_conv_and_gradients_equal_plain_backend(ksz, c):
    """K = 25 with C = 1 takes the C = 1 routes (overflow_apply, window_dw,
    overflow_dw); [3,3,3] the fused backward.  Integer data: exact."""
    sj, st = _plane_pair(seed=2, c=c)
    k = int(np.prod(ksz))
    w0 = torch.from_numpy(
        np.random.default_rng(4).integers(-2, 3, (k, c, 6)).astype(np.float32))
    gy = torch.from_numpy(np.random.default_rng(5).integers(
        -2, 3, (2, CAP, 6)).astype(np.float32))
    plan = teng.build_series_plan(st, ksz, backend=teng.WINDOW, window_r=96)
    assert int(plan.ov_valid.sum()) > 500 and int(plan.ov_dropped.sum()) == 0
    book = trb.build_submanifold_rulebook(st, ksz)
    want_j = jwe.window_submanifold_conv(
        sj, jwe.build_submanifold_window_plan(sj, ksz, interpret=True),
        jnp.asarray(w0.numpy()), interpret=True).feats
    got = []
    for p in (plan, book):
        x = st.feats.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        out = teng.apply_submanifold(st.with_feats(x), p, w).feats
        out.backward(gy)
        got.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert_equal(got[0][0], want_j)
    assert float(got[0][2].abs().sum()) > 0


# ---- the multiplane classifier

OVERRIDES = [
    "data.dimension=2", "data.images=3", "encoder.depth=2",
    "encoder.blocks_per_layer=1", "encoder.n_initial_filters=4",
    "encoder.n_output_filters=8", "run.minibatch_size=2",
    "framework.min_capacity=64", "head.dropout=0.0", "head.hidden=16",
    "mode.optimizer.lr_schedule=flat",
    "mode.optimizer.lr_schedule.peak_learning_rate=0.003",
]


def _cfgs(backend, extra=()):
    ov = OVERRIDES + [f"framework.sparse_backend={backend}", *extra]
    out = []
    for load in (jload, tload):
        cfg = load("synthetic", ov)
        out.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_voxels=256)))
    return out


@pytest.fixture(scope="module")
def data():
    ds = SyntheticDataset(
        8, SyntheticEventConfig(image_size=(32, 32, 32), n_planes=3,
                                max_voxels=256), seed=3)
    return [ds.batch([2 * i, 2 * i + 1]) for i in range(2)]


def _variables(cfg_j, sj, seed):
    """Flax variables with random running statistics, as numpy trees."""
    v = jbuild(cfg_j).init(jax.random.PRNGKey(0), sj, True)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.2, x.shape)).astype(np.float32),
        flax.core.unfreeze(v["batch_stats"]))
    params = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v["params"]))
    return params, stats


@pytest.mark.parametrize("downsampling,merge", [
    ("convolutional", -1), ("convolutional", 1), ("pooling", -1)])
@pytest.mark.parametrize("backend", ["window", "xla"])
def test_multiplane_logits_match_flax(backend, downsampling, merge, data):
    """The port on either backend against the flax model on its plain
    backend (its window backend is the same function; in interpret mode a
    whole model takes minutes)."""
    extra = [f"encoder.plane_merge_depth={merge}",
             f"encoder.downsampling={downsampling}"]
    cfg_j, cfg_t = _cfgs("xla", extra)[0], _cfgs(backend, extra)[1]
    sj = jbatch(data[0]["image"], GRID, capacity=CAP)
    st = tbatch(data[0]["image"], GRID, capacity=CAP)
    params, stats = _variables(cfg_j, sj, 4)
    k_series1 = params["encoder"]["series_1"]["block_0"]["conv1"]["w"].shape[0]
    assert params["encoder"]["initial_w"].shape[0] == 25
    assert k_series1 == (27 if merge == 1 else 9)
    assert params["encoder"]["down_0"]["w"].shape[0] == (
        4 if downsampling == "convolutional" else 1)
    want = jbuild(cfg_j).apply({"params": params, "batch_stats": stats}, sj, False)
    model = tbuild(cfg_t)
    assert model.encoder.capacities == (1024, 512, 512)
    state = params_from_jax(params, stats)
    assert len(state) == len(model.state_dict())
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        got, dropped = model(st)
    assert int(dropped) == 0
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_planes_mix_only_after_the_merge_depth(backend, data):
    """Perturbing plane 0 leaves the encoded features of planes 1 and 2
    untouched at plane_merge_depth = -1 and moves them at 0."""
    st = tbatch(data[0]["image"], GRID, capacity=CAP)
    bump = st.feats + 5.0 * ((st.coords[..., :1] == 0) & st.row_mask()[..., None])
    moved = {}
    for merge in (-1, 0):
        _, cfg_t = _cfgs(backend, [f"encoder.plane_merge_depth={merge}"])
        model = init_parameters(tbuild(cfg_t), 0).eval()
        with torch.no_grad():
            a, _ = model.encoder(st)
            b, _ = model.encoder(st.with_feats(bump))
        others = (a.coords[..., 0] > 0) & a.row_mask()
        assert int(others.sum()) > 0
        moved[merge] = float((a.feats - b.feats)[others].abs().max())
        on_plane0 = (a.coords[..., 0] == 0) & a.row_mask()
        assert float((a.feats - b.feats)[on_plane0].abs().max()) > 1e-4
    assert moved[-1] == 0.0 and moved[0] > 1e-4


@pytest.mark.parametrize("backend", ["window", "xla"])
def test_one_multiplane_train_step_follows_jax(backend, data):
    """From the same state, one AdamW step on the same batch: the metrics
    and every parameter after the update within rtol 1e-3 of the JAX step's
    (the JAX model on its plain backend), then the next batch's loss.  The
    conv biases ahead of a batch norm are left out of the parameter check:
    their true gradient is 0, both sides return rounding noise, and Adam's
    first update turns noise of either sign into a full step."""
    cfg_j, cfg_t = _cfgs("xla")[0], _cfgs(backend)[1]
    sj0 = jbatch(data[0]["image"], GRID, capacity=CAP)
    params, stats = _variables(cfg_j, sj0, 6)
    model_j = jbuild(cfg_j)
    sched_j = jschedule(cfg_j.mode.optimizer.lr_schedule, 4, 1)
    opt = jbuild_optimizer(cfg_j.mode.optimizer, sched_j)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state_j = JTrainState(pj, jax.tree_util.tree_map(jnp.asarray, stats),
                          opt.init(pj), jnp.zeros((), jnp.int32))
    step_j = jax.jit(jtrain_step(model_j, opt, JScheme.focal, sched_j))

    model = tbuild(cfg_t)
    model.load_state_dict(params_from_jax(params, stats))
    sched = build_lr_schedule(cfg_t.mode.optimizer.lr_schedule, 4, 1)
    optimizer, scheduler = build_optimizer(cfg_t.mode.optimizer, sched,
                                           model.parameters())
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(state, tschema.LossBalanceScheme.focal, sched)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, batch in enumerate(data):
        sj = jbatch(batch["image"], GRID, capacity=CAP)
        st, lt = prepare_batch(batch, GRID, CAP, torch.float32,
                               torch.device("cpu"))
        lj = {k: jnp.asarray(batch[k]) for k in OUTPUT_SHAPE}
        state_j, mj = step_j(state_j, sj, lj, None, jax.random.PRNGKey(5))
        mt = step(st, lt, torch.Generator().manual_seed(5))
        assert int(mt["overflow/dropped"]) == 0 == int(mj["overflow/dropped"])
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-3,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        if i == 0:
            want = params_from_jax(
                jax.tree_util.tree_map(np.asarray,
                                       flax.core.unfreeze(state_j.params)),
                jax.tree_util.tree_map(np.asarray,
                                       flax.core.unfreeze(state_j.batch_stats)))
            moved = 0
            for name, p in model.named_parameters():
                if name.endswith(".b"):
                    continue
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=1e-3,
                    atol=1e-5, err_msg=name)
                moved += int(not torch.equal(p.detach(), before[name]))
            assert moved > 20
            for name, buf in model.named_buffers():
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=name)


# ---- the command line

def test_cli_runs_the_synthetic_2d_config_on_the_cpu(tmp_path):
    common = ["--config-name", "synthetic", "data.dimension=2", "data.images=3",
              "run.compute_mode=CPU", "data.synthetic_events=8",
              "encoder.depth=2", "encoder.blocks_per_layer=1",
              "encoder.n_initial_filters=4", f"output_dir={tmp_path}"]
    m = cli(common + ["mode=train", "mode.iterations=2",
                      "framework.sparse_backend=window"])
    assert m["overflow/dropped"] == 0 and np.isfinite(m["loss/loss"])
    assert m["opt/lr"] > 1e-5  # the second step of the warm-up
    m = cli(common + ["mode=inference"])
    assert m["overflow/dropped"] == 0 and np.isfinite(m["loss/loss"])
