"""The rest of the sparse conv engine in the port against the JAX package:
the deconvolution (plain rulebook backend and window engine, forward and
gradients, with the two-step dW over ``window_gather``), the
``ConvolutionUpsample`` block and both branches of ``PoolingDownsample``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_common import assert_equal, both, int_weights, random_coo

from sparseeventid_tpu import ops as jops
from sparseeventid_tpu.config.schema import ConvRepresentation as JRepr
from sparseeventid_tpu.models import blocks as jblocks
from sparseeventid_tpu.ops.pallas import window_conv as jwc
from sparseeventid_tpu.ops.pallas import window_engine as jwe
from sparseeventid_tpu.ops.rulebook import downsample_sites as jds
from sparseeventid_tpu_torch.config.schema import ConvRepresentation as TRepr
from sparseeventid_tpu_torch.convert import params_from_jax
from sparseeventid_tpu_torch.models import blocks as tblocks
from sparseeventid_tpu_torch.ops import conv as tconv
from sparseeventid_tpu_torch.ops import engine as teng
from sparseeventid_tpu_torch.ops import rulebook as trb
from sparseeventid_tpu_torch.ops.window import engine as twe
from sparseeventid_tpu_torch.ops.window import kernels as tk
from sparseeventid_tpu_torch.ops.window import query as tq

GRID = (16, 16, 16)
STRIDE = (2, 2, 2)
C, CO = 6, 5
NC = 512  # coarse capacity


def _fine_and_coarse(integer, seed=7, grid=GRID, stride=STRIDE):
    """(JAX fine, port fine, JAX coarse, port coarse): the coarse features
    are the same numpy array on both sides."""
    coords, feats = random_coo(seed, b=2, n=512, grid=grid, c=3, density=0.1,
                               n_live=[380, 150])
    sj, st = both(coords, feats, grid)
    skj = jds(sj, stride, NC)
    skt = trb.downsample_sites(st, stride, NC)
    assert_equal(skt.coords, skj.coords)
    rng = np.random.default_rng(seed + 1)
    x = (rng.integers(-3, 4, (2, NC, C)) if integer
         else rng.standard_normal((2, NC, C))).astype(np.float32)
    x = x * np.asarray(skj.row_mask())[..., None]
    return sj, st, skj.with_feats(jnp.asarray(x)), skt.with_feats(torch.from_numpy(x))


def _weights(integer, seed=3, k=8):
    rng = np.random.default_rng(seed)
    if integer:
        return int_weights(seed, (k, C, CO)), rng.integers(-2, 3, CO).astype(np.float32)
    return ((rng.standard_normal((k, C, CO)) * 0.3).astype(np.float32),
            rng.standard_normal(CO).astype(np.float32))


def _check(got, want, integer, rtol=1e-4, atol=1e-4):
    if integer:
        assert_equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("stride,grid", [((2, 2, 2), GRID), ((1, 2, 2), (3, 16, 16))])
def test_upsample_rulebook_and_plain_deconv_match_jax(stride, grid):
    sj, st, cj, ct = _fine_and_coarse(True, grid=grid, stride=stride)
    w, bias = _weights(True, k=int(np.prod(stride)))
    rbj = jops.build_upsample(cj, sj, stride)
    rbt = trb.build_upsample(ct, st, stride)
    assert rbt.offsets == rbj.offsets
    assert_equal(rbt.hit, rbj.hit)
    assert_equal(torch.where(rbt.hit, rbt.neighbor_idx, 0),
                 np.where(np.asarray(rbj.hit), np.asarray(rbj.neighbor_idx), 0))
    assert int(rbt.hit.sum(dim=2).max()) == 1
    want = jops.deconv(cj, sj, rbj, jnp.asarray(w), jnp.asarray(bias))
    got = tconv.deconv(ct, st, rbt, torch.from_numpy(w), torch.from_numpy(bias))
    assert_equal(got.feats, want.feats)
    assert float(got.feats.abs().sum()) > 0


def _grads_torch(fn, ct, w, gy):
    x = ct.feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).clone().requires_grad_(True)
    out = fn(ct.with_feats(x), wt).feats
    out.backward(torch.from_numpy(gy))
    return out.detach(), x.grad, wt.grad


@pytest.mark.parametrize("integer", [True, False])
def test_window_deconv_forward_and_grads_match_jax(integer):
    """Forward, dX_coarse and dW against the JAX window_deconv in interpret
    mode (which takes the same two-step dW) and against the JAX xla backend."""
    sj, st, cj, ct = _fine_and_coarse(integer)
    w, _ = _weights(integer)
    rng = np.random.default_rng(12)
    gy = (rng.integers(-2, 3, (2, 512, CO)) if integer
          else rng.standard_normal((2, 512, CO))).astype(np.float32)
    fj, rj = jwe.build_strided_window_plans(sj, cj, STRIDE, interpret=True)
    rbj = jops.build_upsample(cj, sj, STRIDE)

    def loss_win(wj, fx):
        out = jwe.window_deconv(cj.with_feats(fx), sj, fj, rj, wj, interpret=True)
        return jnp.sum(out.feats * jnp.asarray(gy)), out.feats

    def loss_ref(wj, fx):
        out = jops.deconv(cj.with_feats(fx), sj, rbj, wj)
        return jnp.sum(out.feats * jnp.asarray(gy)), out.feats

    want = {}
    for name, loss in (("window", loss_win), ("xla", loss_ref)):
        (gw, gx), out = jax.grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(w), cj.feats)
        want[name] = (out, gx, gw)

    plans = teng.build_upsample_plan(ct, st, STRIDE, backend=teng.WINDOW)
    assert plans[1].offsets == rj.offsets and plans[0].dkeys == fj.dkeys
    before = tk.window_gather_plain.calls
    got = _grads_torch(
        lambda c, wt: teng.apply_upsample(c, st, plans, wt), ct, w, gy)
    assert tk.window_gather_plain.calls == before + 1  # the two-step dW
    for name in ("window", "xla"):
        for g, r in zip(got, want[name]):
            _check(g, r, integer)
    assert all(float(g.abs().sum()) > 0 for g in got)


def test_window_deconv_with_reverse_overflow_list(monkeypatch):
    """A 32-row reverse window pushes pairs onto the reverse plan's list:
    the forward's sidecar and the dW sidecar (x_coarse[src] (outer) gy[dst])
    must complete the in-window parts exactly; without the dW sidecar dW is
    wrong.  Plans and results also equal the JAX engine's at that window."""
    sj, st, cj, ct = _fine_and_coarse(True)
    w, bias = _weights(True)
    gy = np.random.default_rng(13).integers(-2, 3, (2, 512, CO)).astype(np.float32)
    narrow = copy.copy(jwc.TUNING)
    narrow.window_r = 32
    monkeypatch.setattr(jwc, "TUNING", narrow)
    fj, rj = jwe.build_strided_window_plans(sj, cj, STRIDE, interpret=True,
                                            overflow_cap=512)
    assert rj.window_r == 32 and int(np.asarray(rj.ov_valid).sum()) > 0
    plans = teng.build_upsample_plan(
        ct, st, STRIDE, backend=teng.WINDOW, tuning=tq.WindowTuning(window_r=32))
    assert plans[1].ov_valid.shape[1] == st.capacity == 512
    for pt, pj in zip(plans, (fj, rj)):
        for f in ("qmeta", "start", "ov_src", "ov_dst", "ov_k", "ov_valid"):
            assert_equal(getattr(pt, f), getattr(pj, f))
    assert int(plans[1].ov_dropped.sum()) == 0

    def loss_win(wj, fx):
        out = jwe.window_deconv(cj.with_feats(fx), sj, fj, rj, wj, interpret=True)
        return jnp.sum(out.feats * jnp.asarray(gy)), out.feats

    (gw_j, gx_j), out_j = jax.grad(loss_win, argnums=(0, 1), has_aux=True)(
        jnp.asarray(w), cj.feats)
    rbt = trb.build_upsample(ct, st, STRIDE)
    ref = _grads_torch(lambda c, wt: tconv.deconv(c, st, rbt, wt), ct, w, gy)
    got = _grads_torch(
        lambda c, wt: teng.apply_upsample(c, st, plans, wt), ct, w, gy)
    for g, r, j in zip(got, ref, (out_j, gx_j, gw_j)):
        assert torch.equal(g, r)
        assert_equal(g, j)
    # the bias goes on under the row mask
    with torch.no_grad():
        biased = teng.apply_upsample(ct, st, plans, torch.from_numpy(w),
                                     torch.from_numpy(bias)).feats
    assert torch.equal(biased, tconv.deconv(
        ct, st, rbt, torch.from_numpy(w), torch.from_numpy(bias)).feats)
    # planted fault: the dW sidecar left out
    monkeypatch.setattr(
        twe, "_overflow_dw",
        lambda x, g, src, dst, plan: torch.zeros((plan.num_offsets, C, CO)))
    broken = _grads_torch(
        lambda c, wt: teng.apply_upsample(c, st, plans, wt), ct, w, gy)
    assert torch.equal(broken[1], ref[1]) and not torch.equal(broken[2], ref[2])


def _flax_variables(rng, tree):
    """Random values in place of a flax init (so biases and norm scales are
    not all 0 and 1)."""
    return jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32), tree)


@pytest.mark.parametrize("backend", ["xla", "window"])
def test_convolution_upsample_block_matches_flax(backend):
    sj, st, cj, ct = _fine_and_coarse(False)
    mod_j = jblocks.ConvolutionUpsample(n_out=CO, stride=STRIDE, params=JRepr(),
                                        backend=backend)
    v = mod_j.init(jax.random.PRNGKey(0), cj, sj, False)
    rng = np.random.default_rng(5)
    params = _flax_variables(rng, v["params"])
    stats = _flax_variables(rng, v["batch_stats"])
    gy = rng.standard_normal((2, 512, CO)).astype(np.float32)

    def loss(p, fx):
        out, _ = mod_j.apply({"params": p, "batch_stats": stats},
                             cj.with_feats(fx), sj, True,
                             mutable=["batch_stats", "diagnostics"])
        return jnp.sum(out.feats * jnp.asarray(gy)), out.feats

    (gp, gx), want = jax.grad(loss, argnums=(0, 1), has_aux=True)(params, cj.feats)
    mod_t = tblocks.ConvolutionUpsample(C, CO, STRIDE, TRepr(), backend=backend)
    mod_t.load_state_dict(params_from_jax(params, stats))
    mod_t.train()
    x = ct.feats.clone().requires_grad_(True)
    out, dropped = mod_t(ct.with_feats(x), st)
    assert int(dropped) == 0
    out.feats.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(out.feats.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mod_t.w.grad.numpy(), np.asarray(gp["w"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mod_t.b.grad.numpy(), np.asarray(gp["b"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("stride,grid", [((2, 2, 2), GRID), ((1, 2, 2), (3, 16, 16))])
@pytest.mark.parametrize("backend", ["xla", "window"])
def test_pooling_downsample_matches_flax(backend, stride, grid):
    """Both branches (window: tied weights w/V through the strided conv;
    plain: average pool + 1x1) against the flax module, forward and
    gradients, and against each other."""
    coords, feats = random_coo(31, b=2, n=512, grid=grid, c=C, density=0.1,
                               integer=False, n_live=[380, 150])
    if grid[0] == 3:
        coords, feats = random_coo(31, b=2, n=512, grid=grid, c=C, density=0.4,
                                   integer=False, n_live=[300, 150])
    sj, st = both(coords, feats, grid)
    mod_j = jblocks.PoolingDownsample(n_out=CO, stride=stride, params=JRepr(),
                                      out_capacity=NC, backend=backend)
    v = mod_j.init(jax.random.PRNGKey(0), sj, False)
    assert v["params"]["w"].shape == (1, C, CO)
    rng = np.random.default_rng(6)
    params = _flax_variables(rng, v["params"])
    stats = _flax_variables(rng, v["batch_stats"])
    gy = rng.standard_normal((2, NC, CO)).astype(np.float32)

    def loss(p, fx):
        out, _ = mod_j.apply({"params": p, "batch_stats": stats},
                             sj.with_feats(fx), True,
                             mutable=["batch_stats", "diagnostics"])
        return jnp.sum(out.feats * jnp.asarray(gy)), out.feats

    (gp, gx), want = jax.grad(loss, argnums=(0, 1), has_aux=True)(params, sj.feats)

    def run(b):
        mod_t = tblocks.PoolingDownsample(C, CO, stride, TRepr(),
                                          out_capacity=NC, backend=b)
        mod_t.load_state_dict(params_from_jax(params, stats))
        mod_t.train()
        x = st.feats.clone().requires_grad_(True)
        out, dropped = mod_t(st.with_feats(x))
        assert int(dropped) == 0
        out.feats.backward(torch.from_numpy(gy))
        return (out.feats.detach().numpy(), x.grad.numpy(),
                mod_t.w.grad.numpy(), mod_t.b.grad.numpy())

    got = run(backend)
    for g, r in zip(got, (want, gx, gp["w"], gp["b"])):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)
    other = run("window" if backend == "xla" else "xla")
    for g, r in zip(got, other):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    assert np.abs(got[2]).sum() > 0
