"""The dynamic graph CNN's edge convolution (``ops/edge_conv_kernels``) on
the CPU, where it runs its plain version: against the composition the
port's ``EdgeConv`` ran before it (edge features [..., P, k, 2F], the
Dense, ``MaskedPointBN`` over the flattened edges, leaky ReLU 0.2, the max
over the neighbours, autograd for the backward) in forward output, moved
running statistics and the gradients of x, the Dense's weight and the
norm's scale and offset.  The card's kernels are held to the plain version
in ``tests/test_torch_dgcnn.py`` (``-m card``).  This file imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sparseeventid_tpu_torch.models.dense import leaky_relu
from sparseeventid_tpu_torch.models.dgcnn import (
    EdgeConv,
    edge_features,
    knn_indices,
)
from sparseeventid_tpu_torch.models.pointnet import MaskedPointBN
from sparseeventid_tpu_torch.ops import edge_conv_kernels as EK


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def composed(x, idx, mask, weight, bn: MaskedPointBN):
    """The stage as the port composed it before its kernels."""
    h = edge_features(x, idx) @ weight.t()
    lead = h.shape[:-3]
    flat = mask[..., None].expand(h.shape[:-1]).reshape(*lead, -1)
    h = bn(h.reshape(*lead, -1, h.shape[-1]), flat).reshape(h.shape)
    return torch.where(mask[..., None], leaky_relu(h, 0.2).amax(dim=-2), 0)


# name: (leading dims, P, F, C, k, valid points a cloud, integer data,
# channels of negative scale, training)
CASES = {
    "real": ((2,), 40, 4, 16, 8, (40, 31), False, 0, True),
    "negative_scale": ((2,), 40, 12, 16, 8, (40, 29), False, 7, True),
    "short_cloud": ((3,), 24, 8, 12, 10, (24, 6, 20), False, 4, True),
    "eval": ((2,), 40, 8, 16, 8, (40, 25), False, 5, False),
    "multiplane": ((2, 3), 32, 4, 8, 6, (32, 20, 32, 9, 32, 32), False, 3,
                   True),
    "integer_ties": ((2,), 36, 4, 8, 12, (36, 10), True, 3, True),
}


def _inputs(case, seed=0):
    lead, p, f, c, k, valid, integer, negative, training = CASES[case]
    rng = np.random.default_rng(seed)
    shape = (*lead, p, f)
    if integer:  # ties everywhere, every sum exact
        x = rng.integers(-2, 3, size=shape).astype(np.float32)
        w = rng.integers(-2, 3, size=(c, 2 * f)).astype(np.float32)
        scale = rng.integers(1, 3, size=c).astype(np.float32)
        bias = rng.integers(-1, 2, size=c).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        x[..., 0] *= 30.0
        w = (rng.standard_normal((c, 2 * f)) / np.sqrt(2 * f)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bias = rng.normal(0.0, 0.3, c).astype(np.float32)
    scale[:negative] *= -1.0
    mask = np.zeros((*lead, p), bool).reshape(-1, p)
    for i, n in enumerate(valid):
        mask[i, :n] = True
    mask = mask.reshape(*lead, p)
    # padded points hold zeros, as a stage's input does after the first
    x[~mask] = 0.0
    return (torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(w),
            torch.from_numpy(scale), torch.from_numpy(bias), k, training)


def _run(fn, x, w, scale, bias, grad_seed=1):
    """fn(x, w, scale, bias) -> (out, d x, d w, d scale, d bias) for a
    random cotangent."""
    leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, bias)]
    out = fn(*leaves)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(grad_seed))
    (out * g).sum().backward()
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_composed_stage(case, one_torch_thread):
    """Forward output, the running statistics after a training forward, and
    the gradients of x, the weight, the scale and the offset, to float32
    tolerance: the plain version sums the statistics in float64 and adds
    A[j] + Bp[i] where the composition multiplies [x_j - x_i, x_i] by W.
    Cases: real-valued clouds with padded points; channels of negative
    scale (the min branch); a cloud of fewer than k valid points (its
    padded neighbours tie); eval mode (the running statistics);
    multiplane clouds [B, planes, P, F]; integer-valued data with tied
    maxima, where the gradient is split evenly among the tied edges as
    ``torch.amax`` splits it."""
    x, mask, w, scale, bias, k, training = _inputs(case)
    idx = knn_indices(x, mask, k)
    c = w.shape[0]
    rng = np.random.default_rng(5)
    mean0 = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    var0 = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    bn_ref = MaskedPointBN(c)
    bn_ref.mean.copy_(mean0)
    bn_ref.var.copy_(var0)
    bn_ref.train(training)
    del bn_ref.scale, bn_ref.bias  # plain attributes: the leaves below
    run_mean, run_var = mean0.clone(), var0.clone()

    def ref(xx, ww, ss, bb):
        bn_ref.scale, bn_ref.bias = ss, bb
        return composed(xx, idx, mask, ww, bn_ref)

    def plain(xx, ww, ss, bb):
        return EK.edge_conv(xx, idx, mask, ww, ss, bb, run_mean, run_var,
                            training=training, momentum=bn_ref.momentum,
                            eps=bn_ref.eps)

    calls = EK.edge_conv_plain.calls, EK.edge_conv_backward_plain.calls
    launches = EK.edge_conv.launches, EK.edge_conv_backward.launches
    want = _run(ref, x, w, scale, bias)
    got = _run(plain, x, w, scale, bias)
    assert (EK.edge_conv_plain.calls, EK.edge_conv_backward_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert (EK.edge_conv.launches,
            EK.edge_conv_backward.launches) == launches
    assert got[0].shape == (*x.shape[:-1], c)
    assert float(got[0][~mask].abs().max()) == 0.0
    for name, a, b in zip(("out", "x", "weight", "scale", "bias"), got, want):
        scale_ = float(b.abs().max())
        assert scale_ > 0, name
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * scale_, msg=name)
    torch.testing.assert_close(run_mean, bn_ref.mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(run_var, bn_ref.var, rtol=1e-5, atol=1e-6)
    if not training:
        assert torch.equal(run_mean, mean0) and torch.equal(run_var, var0)
    if CASES[case][6]:  # the tie rule is exercised
        h = (edge_features(x, idx) @ w.t())
        top = h.amax(dim=-2, keepdim=True)
        assert int(((h == top).sum(-2) > 1)[mask].sum()) > 0


def test_integer_forward_is_exact_against_the_composition():
    """With the running statistics (eval mode) on integer data every edge
    value is exact, so the max taken before the affine gives the
    composition's output bit for bit."""
    x, mask, w, scale, bias, k, _ = _inputs("integer_ties")
    idx = knn_indices(x, mask, k)
    bn = MaskedPointBN(w.shape[0])
    bn.scale.data.copy_(scale)
    bn.bias.data.copy_(bias)
    with torch.no_grad():
        want = composed(x, idx, mask, w, bn.eval())
        got = EK.edge_conv(x, idx, mask, w, scale, bias, bn.mean.clone(),
                           bn.var.clone(), training=False,
                           momentum=bn.momentum, eps=bn.eps)
    assert torch.equal(got, want)


def test_reverse_index_groups_the_valid_edges_by_neighbour():
    """Each point's incoming edges, valid points only, in ascending edge
    order."""
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, 7, size=(2, 7, 3)))
    mask = torch.ones((2, 7), dtype=torch.bool)
    mask[1, 4:] = False
    keys, edges, starts = EK.reverse_index(idx, mask)
    assert starts.shape == (15,) and int(starts[-1]) == 11 * 3
    for j in range(14):
        got = edges[starts[j]:starts[j + 1]].tolist()
        want = [e for e in range(42) if mask.reshape(-1)[e // 3]
                and (e // 21) * 7 + int(idx.reshape(-1)[e]) == j]
        assert got == want, j
        assert (keys[starts[j]:starts[j + 1]] == j).all()
    assert (keys[starts[-1]:] == 14).all()


def test_stage_keeps_no_edge_tensor_for_the_backward():
    """An EdgeConv's forward saves no float tensor [..., P, k, C] or
    [..., P, k, 2F] for the backward; its running statistics move in
    training and not in eval mode."""
    p, k = 40, 8
    conv = EdgeConv(6, 16, k).train()
    x, mask, *_ = _inputs("real")
    x = torch.cat([x, x[..., :2]], dim=-1).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = conv(x, mask)
    out.sum().backward()
    assert saved
    assert not [s for s, dtype in saved
                if dtype.is_floating_point and len(s) >= 3 and s[-3:-1] == (p, k)]
    assert float(conv.bn.mean.abs().sum()) > 0
    mean = conv.bn.mean.clone()
    with torch.no_grad():
        conv.eval()(x, mask)
    assert torch.equal(conv.bn.mean, mean)
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
