"""The host plan layer of the PyTorch port against the JAX package:
``io.hostio.build_window_plans`` (csrc/hostio_core.h) against the JAX
package's own C++ builder compiled from its source, host plans against the
port's device plans conv by conv, and the model on host plans against the
JAX model fed the JAX builder's plans."""

import dataclasses
import importlib.util
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparseeventid_tpu.config import load_config as jload
from sparseeventid_tpu.config.schema import OUTPUT_SHAPE
from sparseeventid_tpu.io import SyntheticDataset, SyntheticEventConfig
from sparseeventid_tpu.io.transforms import larcv_batch_to_sparse_3d as jbatch
from sparseeventid_tpu.models import build_sparse_classifier as jbuild
from sparseeventid_tpu.ops.host_plans import encoder_plans_from_host as jplans
from sparseeventid_tpu.train.supervised import make_loss_fn
from sparseeventid_tpu.config.schema import LossBalanceScheme as JScheme
from sparseeventid_tpu_torch.config import load_config as tload
from sparseeventid_tpu_torch.config.schema import LossBalanceScheme
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.io import hostio
from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d as tbatch
from sparseeventid_tpu_torch.models import build_sparse_classifier as tbuild
from sparseeventid_tpu_torch.ops import build_sparse_tensor, downsample_sites
from sparseeventid_tpu_torch.ops.host_plans import encoder_plans_from_host
from sparseeventid_tpu_torch.ops.window.engine import (
    build_strided_window_plans,
    build_submanifold_window_plan,
    window_strided_conv,
    window_submanifold_conv,
)
from sparseeventid_tpu_torch.ops.window.kernels import _ov_bound, overflow_dst_ordered
from sparseeventid_tpu_torch.ops.window.query import WindowTuning
from sparseeventid_tpu_torch.train.losses import multi_head_loss
from sparseeventid_tpu_torch.train.plans import HostPlanner, plan_coords


@pytest.fixture(scope="module")
def jax_hostio(tmp_path_factory):
    """The JAX package's own C++ plan builder (``sparseeventid_tpu/io/
    _hostio.cpp``), compiled by g++ into a temporary directory and loaded
    by file path as ``_hostio``; nothing is written into the JAX package.
    Skips, naming the reason, where g++ or Python.h is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the JAX builder cannot be compiled")
    include = sysconfig.get_paths()["include"]
    if not (Path(include) / "Python.h").exists():
        pytest.skip(f"Python.h not found under {include}")
    src = Path(__file__).resolve().parents[1] / "sparseeventid_tpu" / "io" / "_hostio.cpp"
    out = tmp_path_factory.mktemp("jax_hostio") / (
        "_hostio" + sysconfig.get_config_var("EXT_SUFFIX"))
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         f"-I{include}", f"-I{np.get_include()}", "-o", str(out), str(src),
         "-ldl"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    spec = importlib.util.spec_from_file_location("_hostio", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_torch_thread():
    """The port's small CPU tensors run fastest on one thread (about 3x
    faster than on eight cores), and far faster beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(seed, b, cap, grid, n, shuffle=True, junk=False):
    """-1 padded coordinates of ``b`` events of up to ``n`` unique sites
    each, clustered along tracks so the plans' windows matter; unsorted
    (``shuffle``), with rows of -1 and -999 inside (``junk``)."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, cap, 3), -1, np.int32)
    for i in range(b):
        start = rng.integers(0, grid, (8, 3))
        steps = rng.integers(-1, 2, (8, n // 8, 3))
        pts = np.clip(start[:, None] + np.cumsum(steps, 1), 0,
                      np.asarray(grid) - 1).reshape(-1, 3)
        pts = np.unique(pts.astype(np.int32), axis=0)[:n]
        if shuffle:
            pts = pts[rng.permutation(len(pts))]
        coords[i, :len(pts)] = pts
        if junk:
            coords[i, len(pts):len(pts) + 3] = -999
            coords[i, [1, 7]] = coords[i, [len(pts) + 5, len(pts) + 6]]
            coords[i, 3, 0] = -999
    return coords


CASES = {
    # grid, caps, initial kernel, series kernels, stride, sites an event
    "3d": dict(grid=(48, 48, 48), caps=[1024, 512, 512], initial=(5, 5, 5),
               series=(3, 3, 3), stride=(2, 2, 2), n=900),
    # the multiplane model with plane_merge_depth = 1: [1,3,3] at level 0,
    # [3,3,3] from level 1 on
    "2d_multiplane": dict(grid=(3, 64, 64), caps=[1536, 1024, 512],
                          initial=(1, 5, 5),
                          series=((1, 3, 3), (3, 3, 3), (3, 3, 3)),
                          stride=(1, 2, 2), n=1200),
}


def _kwargs(case, r=32, widths=None):
    c = CASES[case]
    depth = len(c["caps"]) - 1
    sks = c["series"] if hasattr(c["series"][0], "__len__") else [c["series"]] * (depth + 1)
    wide = lambda cap, k: widths or cap * k  # noqa: E731 (holds every pair)
    return dict(
        grid=c["grid"], caps=c["caps"], initial_kernel=c["initial"],
        series_kernel=c["series"], stride=c["stride"], window_r=r,
        ov_caps=[wide(cap, int(np.prod(k))) for cap, k in zip(c["caps"], sks)],
        ov_cap_initial=wide(c["caps"][0], int(np.prod(c["initial"]))),
        ov_caps_down=[wide(cap, 8) for cap in c["caps"][:-1]],
        window_r_down=r + 16, window_r_initial=r,
        window_r_series=[r, r + 16, r],
    )


def _coords(case, junk=False, b=3):
    c = CASES[case]
    grid = c["grid"]
    coords = _events(5, b, c["caps"][0] - 64, grid, c["n"], junk=junk)
    if case == "2d_multiplane":
        coords[..., 0] %= 3
        for i in range(b):  # unique again after folding onto 3 planes
            live = coords[i][coords[i, :, 0] >= 0]
            u = np.unique(live, axis=0)
            coords[i] = -1
            coords[i, :len(u)] = u[np.random.default_rng(i).permutation(len(u))]
    return coords


def _lists(d, prefix, e):
    v = d[f"{prefix}/ov_valid"][e]
    return list(zip(d[f"{prefix}/ov_src"][e][v].tolist(),
                    d[f"{prefix}/ov_dst"][e][v].tolist(),
                    d[f"{prefix}/ov_k"][e][v].tolist()))


def _prefixes(d):
    return [k[:-len("/start")] for k in d if k.endswith("/start")]


@pytest.mark.parametrize("case,junk", [("3d", False), ("2d_multiplane", False),
                                       ("3d", True)])
def test_builder_matches_jax(case, junk, jax_hostio):
    """Starts, level coordinates, live counts and every drop count
    bit-equal to the JAX builder's; each list the same (src, dst, k) set per
    event, in (dst, k) order; the lists fill (narrow windows)."""
    coords = _coords(case, junk)
    kw = _kwargs(case)
    want = jax_hostio.build_window_plans(coords, **kw)
    got = hostio.build_window_plans(coords, **kw)
    assert set(got) == set(want)
    for key in want:
        if key.rsplit("/", 1)[-1] in ("ov_src", "ov_dst", "ov_k", "ov_valid"):
            assert got[key].shape == want[key].shape, key
            continue
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    filled = 0
    for prefix in _prefixes(want):
        for e in range(coords.shape[0]):
            pairs = _lists(got, prefix, e)
            assert sorted(pairs) == sorted(_lists(want, prefix, e)), prefix
            assert pairs == sorted(pairs, key=lambda p: (p[1], p[2])), prefix
            filled += len(pairs)
        assert not want[f"{prefix}/ov_dropped"].any()
    assert filled > 1000


def test_clamped_list_keeps_its_first_pairs(jax_hostio):
    """A width below the pair count: the same ov_dropped as the JAX
    builder, and the list is the first ``width`` pairs in (dst, k) order."""
    coords = _coords("3d")
    full = hostio.build_window_plans(coords, **_kwargs("3d"))
    kw = _kwargs("3d", widths=40)
    want = jax_hostio.build_window_plans(coords, **kw)
    got = hostio.build_window_plans(coords, **kw)
    clamped = 0
    for prefix in _prefixes(want):
        np.testing.assert_array_equal(got[f"{prefix}/ov_dropped"],
                                      want[f"{prefix}/ov_dropped"], err_msg=prefix)
        np.testing.assert_array_equal(got[f"{prefix}/start"], want[f"{prefix}/start"])
        for e in range(coords.shape[0]):
            assert _lists(got, prefix, e) == _lists(full, prefix, e)[:40]
        clamped += int((got[f"{prefix}/ov_dropped"] > 0).sum())
    assert clamped > 5


def test_threaded_matches_serial(monkeypatch):
    """SEID_PLAN_THREADS 4 gives the bits of a serial build (counterpart of
    tests/test_hostio.py's threaded test)."""
    coords = _coords("3d", b=8)
    kw = _kwargs("3d")
    monkeypatch.setenv("SEID_PLAN_THREADS", "1")
    hostio.plan_pool_peak_concurrency()
    serial = hostio.build_window_plans(coords, **kw)
    assert hostio.plan_pool_peak_concurrency() == 1
    monkeypatch.setenv("SEID_PLAN_THREADS", "4")
    threaded = hostio.build_window_plans(coords, **kw)
    assert serial.keys() == threaded.keys()
    for key in serial:
        np.testing.assert_array_equal(serial[key], threaded[key], err_msg=key)


def test_pool_overlaps_events(monkeypatch):
    """With SEID_PLAN_TEST_DELAY_US each event sleeps first: 8 workers
    overlap the sleeps (at least 3x faster than 1), and the watermark sees
    more than one worker inside the builder at once."""
    coords = _coords("3d", b=8)
    kw = _kwargs("3d")
    delay_us = 60_000
    monkeypatch.setenv("SEID_PLAN_TEST_DELAY_US", str(delay_us))
    monkeypatch.setenv("SEID_PLAN_THREADS", "1")
    t0 = time.perf_counter()
    hostio.build_window_plans(coords, **kw)
    t_serial = time.perf_counter() - t0
    hostio.plan_pool_peak_concurrency()
    monkeypatch.setenv("SEID_PLAN_THREADS", "8")
    t0 = time.perf_counter()
    hostio.build_window_plans(coords, **kw)
    t_pool = time.perf_counter() - t0
    assert t_serial >= 8 * delay_us * 1e-6
    assert t_serial / t_pool >= 3.0, (t_serial, t_pool)
    assert hostio.plan_pool_peak_concurrency() > 1


# ---- host plans against the port's device plans, conv by conv (CPU: the
# kernels' plain versions), on integer-valued fp32 data

TUNING = WindowTuning(window_r=32, window_r_strided=48, window_r_initial=32,
                      window_r_deep=32, window_r_deep_from=3)


def _host_geometry(case):
    c = CASES[case]
    depth = len(c["caps"]) - 1
    sks = c["series"] if hasattr(c["series"][0], "__len__") else [c["series"]] * (depth + 1)
    kw = _kwargs(case)
    kw.update(window_r=TUNING.window_r, window_r_down=TUNING.window_r_strided,
              window_r_initial=TUNING.window_r_initial,
              window_r_series=[TUNING.for_level(l) for l in range(depth + 1)])
    return kw, sks, depth


def _conv_grads(fn, feats, w, seed):
    x = feats.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    out = fn(x, wt)
    g = torch.from_numpy(np.random.default_rng(seed).integers(
        -2, 3, tuple(out.feats.shape)).astype(np.float32))
    (out.feats * g).sum().backward()
    return out.feats.detach(), x.grad, wt.grad


@pytest.mark.parametrize("case", ["3d", "2d_multiplane"])
def test_host_plans_equal_device_plans(case, one_torch_thread):
    """Skeletons equal downsample_sites; every conv of an encoder pass
    (initial, series, strided forward with its reverse plan) gives the same
    output, dX and dW on host plans as on device plans; every host list is
    dst-ordered."""
    kw, sks, depth = _host_geometry(case)
    c = CASES[case]
    coords = _coords(case, junk=True)
    b = coords.shape[0]
    host = {k: torch.from_numpy(v) for k, v in
            hostio.build_window_plans(coords, **kw).items()}
    rng = np.random.default_rng(1)
    feats = rng.integers(-3, 4, (b, coords.shape[1], 1)).astype(np.float32)
    st0 = build_sparse_tensor(torch.from_numpy(coords), torch.from_numpy(feats),
                              c["grid"], capacity=c["caps"][0])
    plans = encoder_plans_from_host(st0, host, depth, c["initial"], sks,
                                    c["stride"], tuning=TUNING)
    assert int(plans.site_dropped) == 0
    for p in (plans.initial, *plans.series, *[q for d in plans.down for q in d]):
        assert overflow_dst_ordered(p.ov_dst, _ov_bound(p.ov_valid))
        assert int(p.ov_dropped.sum()) == 0

    def same(host_fn, dev_fn, x, w, what):
        for a, d in zip(_conv_grads(host_fn, x, w, 3), _conv_grads(dev_fn, x, w, 3)):
            assert torch.equal(a, d), what

    width = lambda st, k: st.capacity * k  # noqa: E731 (device: every candidate)
    k_i = int(np.prod(c["initial"]))
    dev = build_submanifold_window_plan(st0, c["initial"], TUNING.window_r_initial,
                                        width(st0, k_i))
    w = torch.from_numpy(rng.integers(-2, 3, (k_i, 1, 4)).astype(np.float32))
    same(lambda x, w: window_submanifold_conv(st0.with_feats(x), plans.initial, w),
         lambda x, w: window_submanifold_conv(st0.with_feats(x), dev, w),
         st0.feats, w, "initial")
    st = st0.with_feats(torch.from_numpy(
        rng.integers(-3, 4, (b, c["caps"][0], 4)).astype(np.float32)))
    for l in range(depth + 1):
        k = int(np.prod(sks[l]))
        dev = build_submanifold_window_plan(st, sks[l], TUNING.for_level(l),
                                            width(st, k))
        w = torch.from_numpy(rng.integers(-2, 3, (k, 4, 4)).astype(np.float32))
        same(lambda x, w: window_submanifold_conv(st.with_feats(x), plans.series[l], w),
             lambda x, w: window_submanifold_conv(st.with_feats(x), dev, w),
             st.feats, w, f"series {l}")
        if l == depth:
            break
        skel, dropped = downsample_sites(st, c["stride"], c["caps"][l + 1],
                                         with_dropped=True)
        hs = plans.skeletons[l]
        assert torch.equal(hs.coords, skel.coords) and torch.equal(hs.n_active, skel.n_active)
        assert int(dropped.sum()) == 0
        fwd, rev = build_strided_window_plans(st, skel, c["stride"], width(st, 8),
                                              tuning=TUNING)
        w = torch.from_numpy(rng.integers(-2, 3, (len(fwd.offsets), 4, 4)
                                          ).astype(np.float32))
        same(lambda x, w: window_strided_conv(st.with_feats(x), hs, *plans.down[l], w),
             lambda x, w: window_strided_conv(st.with_feats(x), skel, fwd, rev, w),
             st.feats, w, f"down {l}")
        st = skel.with_feats(torch.from_numpy(
            rng.integers(-3, 4, (b, skel.capacity, 4)).astype(np.float32)))


def test_planner_widens_lists_rather_than_drop():
    """Widths far below the pair counts: the planner builds the batch again
    with lists that hold every pair, the pairs of a wide build."""
    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train.plans import grown_widths

    cfg = tload("synthetic", ["framework.sparse_backend=window",
                              "encoder.depth=1", "data.max_voxels=1024"])
    planner = HostPlanner(build_sparse_classifier(cfg).encoder, (48, 48, 48))
    geo = planner.geometry
    geo.update(ov_caps=[16, 16], ov_cap_initial=16, ov_caps_down=[16],
               window_r=32, window_r_initial=32, window_r_series=[32, 32],
               window_r_down=32)
    coords = _events(7, 3, 1024, (48, 48, 48), 900)
    narrow = hostio.build_window_plans(coords, **geo)
    assert grown_widths(narrow, geo) is not None
    got = planner.build_coords(coords)
    wide = hostio.build_window_plans(coords, **_kwargs_like(geo, 1024 * 125))
    assert not any(got[k].any() for k in got if k.endswith("ov_dropped"))
    for prefix in _prefixes(got):
        for e in range(coords.shape[0]):
            assert _lists(got, prefix, e) == _lists(wide, prefix, e), prefix
        assert got[f"{prefix}/ov_valid"].shape[1] % 256 == 0


def _kwargs_like(geo, width):
    return dict(geo, ov_caps=[width] * len(geo["ov_caps"]), ov_cap_initial=width,
                ov_caps_down=[width] * len(geo["ov_caps_down"]))


def test_layout_guard_raises():
    """A host dict built for another level-0 capacity than the tensor's."""
    kw, sks, depth = _host_geometry("3d")
    c = CASES["3d"]
    coords = _coords("3d")
    host = {k: torch.from_numpy(v) for k, v in
            hostio.build_window_plans(coords, **kw).items()}
    st = build_sparse_tensor(torch.from_numpy(coords),
                             torch.ones(coords.shape[:2] + (1,)), c["grid"],
                             capacity=c["caps"][0] + 512)
    with pytest.raises(ValueError, match="query tiles"):
        encoder_plans_from_host(st, host, depth, c["initial"], sks, c["stride"],
                                tuning=TUNING)


# ---- the model on host plans against the JAX model fed the JAX builder's
# plans (fp32)

GRID = (16, 16, 16)
R = 32  # narrow windows, so the lists fill
OVERRIDES = [
    "data=synthetic", "encoder.depth=1", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
    "run.minibatch_size=2", "framework.min_capacity=64", "head.dropout=0.0",
    "head.hidden=32", "framework.sparse_backend=window",
    f"framework.tuning.window_r={R}", f"framework.tuning.window_r_strided={R}",
    f"framework.tuning.window_r_initial={R}",
]


@pytest.fixture(scope="module")
def model_setup(jax_hostio):
    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    batch = ds.batch([0, 1])
    cfgs = []
    for load in (jload, tload):
        cfg = load("synthetic", OVERRIDES)
        cfgs.append(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, max_voxels=256)))
    model = tbuild(cfgs[1])
    planner = HostPlanner(model.encoder, GRID)
    geo = planner.geometry  # lists wide enough for every pair at R = 32
    geo["ov_caps"] = [c * 27 for c in geo["caps"]]
    geo["ov_cap_initial"] = geo["caps"][0] * 125
    geo["ov_caps_down"] = [c * 8 for c in geo["caps"][:-1]]
    host = planner.build(batch["image"])
    jhost = jax_hostio.build_window_plans(
        plan_coords(batch["image"], GRID), **planner.geometry)
    sj = jbatch(batch["image"], GRID, capacity=512)
    # parameter shapes do not depend on the backend: initialise on xla
    cfg_x = dataclasses.replace(cfgs[0], framework=dataclasses.replace(
        cfgs[0].framework, sparse_backend="xla"))
    variables = jbuild(cfg_x).init(jax.random.PRNGKey(0), sj, True)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model.load_state_dict(params_from_jax(params, stats))
    return dict(batch=batch, cfg_j=cfgs[0], cfg_x=cfg_x, model=model,
                planner=planner, host=host, jhost=jhost, sj=sj, params=params,
                stats=stats)


def _jax_plans(setup):
    ik, sks, stride = setup["model"].encoder.plan_kernels()
    return jplans(setup["sj"], {k: jnp.asarray(v) for k, v in setup["jhost"].items()},
                  1, ik, sks, stride, window_r_initial=R,
                  window_r_series=[R, R], window_r_down=R, window_r_rev=R)


def test_lists_fill_without_drops(model_setup):
    host = model_setup["host"]
    assert sum(int(host[k].sum()) for k in host if k.endswith("ov_valid")) > 5000
    assert not any(host[k].any() for k in host
                   if k.endswith("ov_dropped") or k.endswith("site_dropped"))


def test_model_forward_matches_jax_on_host_plans(model_setup, one_torch_thread):
    """Eval-mode logits within rtol 1e-4 (the window kernels of both
    packages on their host plans; the JAX one in interpret mode)."""
    s = model_setup
    want = jbuild(s["cfg_j"]).apply(
        {"params": s["params"], "batch_stats": s["stats"]}, s["sj"], False,
        _jax_plans(s))
    st = tbatch(s["batch"]["image"], GRID, capacity=512)
    with torch.no_grad():
        got, dropped = s["model"].eval()(
            st, plans=s["planner"].plans(st, s["planner"].to_device(s["host"], "cpu")))
    assert int(dropped) == 0
    for k in OUTPUT_SHAPE:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5)


def test_train_step_matches_jax_on_host_plans(model_setup, one_torch_thread):
    """One train-mode forward and backward on host plans: loss within rtol
    1e-5 and every parameter gradient within rtol 1e-3 of the JAX model's
    on its plain xla backend (the same function as its window backend on
    host plans, which takes minutes in interpret mode on a CPU); the same
    atol rule as tests/test_torch_train_step.py."""
    s = model_setup
    labels = {k: s["batch"][k] for k in OUTPUT_SHAPE}
    loss_fn = make_loss_fn(jbuild(s["cfg_x"]), JScheme.focal)
    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        s["params"], s["stats"], s["sj"],
        {k: jnp.asarray(v) for k, v in labels.items()}, None,
        jax.random.PRNGKey(1), True)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    model = s["model"].train()
    model.zero_grad(set_to_none=True)
    st = tbatch(s["batch"]["image"], GRID, capacity=512)
    logits, dropped = model(
        st, plans=s["planner"].plans(st, s["planner"].to_device(s["host"], "cpu")))
    loss, _ = multi_head_loss(logits, {k: torch.from_numpy(v) for k, v in labels.items()},
                              LossBalanceScheme.focal)
    loss.backward()
    assert int(dropped) == 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    named = dict(model.named_parameters())
    floor = 1e-5 * max(float(want[n].abs().max()) for n in named)
    for name, p in named.items():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=max(1e-4 * np.abs(g).max(), floor),
                                   err_msg=name)
    model.load_state_dict(params_from_jax(s["params"], s["stats"]))


# ---- the command line on the CPU: plans built in the loader's thread, the
# metrics of a SEID_HOST_PLANS=0 run

CLI = ["--config-name", "synthetic", "run.compute_mode=CPU",
       "framework.sparse_backend=window", "encoder.depth=2",
       "encoder.blocks_per_layer=1", "encoder.n_initial_filters=8",
       "encoder.n_output_filters=16", "data.max_voxels=256",
       "data.synthetic_events=4", "head.hidden=32"]


def test_cli_on_host_plans_equals_device_plans(monkeypatch, tmp_path,
                                              one_torch_thread):
    from sparseeventid_tpu_torch.__main__ import main

    threads = []
    build = HostPlanner.build

    def recording(self, image, indices=None, split=""):
        threads.append(threading.current_thread().name)
        return build(self, image, indices, split)

    monkeypatch.setattr(HostPlanner, "build", recording)
    out = {}
    for source, env in (("host", "1"), ("device", "0")):
        monkeypatch.setenv("SEID_HOST_PLANS", env)
        args = CLI + [f"output_dir={tmp_path / source}"]
        out[source] = (main(args + ["mode=train", "mode.iterations=3"]),
                       main(args + ["mode=inference"]))
        if source == "host":
            # the train run's loaders, then validate's own thread
            assert threads and all(t != threading.main_thread().name
                                   for t in threads[:3]), threads
            assert threading.main_thread().name in threads  # validate's
            n_host = len(threads)
    assert len(threads) == n_host  # SEID_HOST_PLANS=0 builds none
    for a, b in zip(out["host"], out["device"]):
        a = {k: v for k, v in a.items() if not k.startswith("time/")}
        b = {k: v for k, v in b.items() if not k.startswith("time/")}
        assert a == b
        assert a["overflow/dropped"] == 0
