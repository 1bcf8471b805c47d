"""The dynamic graph CNN's edge convolution after its neighbour search as
CUDA kernels (``csrc/edge_conv.cu``), with its plain PyTorch version
beside them, and the autograd Function that runs a stage as one matrix
product and one wrapper call forward, and one wrapper call and two matrix
products backward.

A stage maps each point i of a cloud and each of its k neighbours j to
the edge h_ik = W [x_j - x_i, x_i] (``fc.weight`` W [C, 2F], no bias),
normalises h over the edges of the valid points (all k of each, padded
neighbours included), applies scale, offset and the leaky ReLU, and keeps
the max over the k neighbours; a padded point's output is 0.  Two
identities keep every [..., P, k, C] tensor off the card:

- the Dense split by linearity: with W = [W_d, W_i],
  h_ik = A[j] + Bp[i], A = x W_d^T, Bp = x (W_i - W_d)^T, so one product
  [..., P, F] x [F, 2C] forms both per point and an edge is two rows added
  in registers;
- the max through the affine: y = leaky(((h - mean) rstd) scale + offset),
  each operation rounded, is non-decreasing in h where scale >= 0 and
  non-increasing where scale < 0, so max_k y = y(max_k h), or y(min_k h):
  the forward keeps one [..., P, C] extreme and normalises only it.

The batch norm's statistics are the sums of h and h^2 in float64 over the
valid edges (count k per valid point, at least 1), mean = s1 / count and
var = max(s2 / count - mean^2, 0) in float64, both rounded to float32,
rstd = 1 / sqrt(var + eps) in float32; the running averages move as
``MaskedPointBN``'s, ``x <- momentum x + (1 - momentum) stat``.  Eval mode
uses the running statistics.  The gradient of the max goes to every edge
whose y equals the max, split evenly among them (``torch.amax``'s rule):
the backward recomputes each edge's y and compares.  Through the norm an
edge's gradient is dh = a dn + c1 + c2 xhat, with a = scale rstd, dn the
edge's share through the leaky ReLU, xhat = (h - mean) rstd, and per
channel c1 = -a (sum dn) / count, c2 = -a gate (sum dn xhat) / count (gate
0 where the variance was clamped; c1 = c2 = 0 in eval mode).  Then
dBp[i] = sum_k dh_ik and dA[j] = the sum of dh over the edges that point
at j, taken in edge order from a reverse index of the neighbour lists (no
float atomics), and the two matrix products of the Dense's backward.

``edge_conv`` dispatches as ``knn_kernels.knn_topk`` does: a CPU tensor
goes to the plain version, a CUDA tensor to the kernels, which raise on a
failed build or launch; there is no fallback.  On the card it counts its
forward calls in ``edge_conv.launches`` and its backward calls in
``edge_conv_backward.launches`` (three kernels forward, five backward),
and, while the tracer records, ``edge_conv_fused`` once a forward; the
plain versions count their calls in ``edge_conv_plain.calls`` and
``edge_conv_backward_plain.calls``.  The plain versions are the same
algorithm in torch ops (they hold the [..., P, k, C] edges, on the CPU);
on integer-valued inputs small enough that every sum is exact the kernels
give their forward bit for bit.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils import telemetry
from .norm_kernels import norm_geometry
from .window import _native
from .window.kernels import _check, _ptr, _stream, _use_kernel

MAX_K = 32  # neighbours a point on the card, as csrc/knn.cu finds them
CHUNK = 32  # edges a group sums in the backward's scatter pass
SLOPE = 0.2  # the leaky ReLU after the norm, DGCNN's


def _leaky(v: torch.Tensor) -> torch.Tensor:
    """flax's leaky ReLU (``models/dense.leaky_relu``): slope 1 at 0."""
    return torch.where(v >= 0, v, SLOPE * v)


def _edges(ab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [N, P, k, C] = A[idx] + Bp of ab [N, P, 2C] = [A, Bp]."""
    n, p, k = idx.shape
    c = ab.shape[-1] // 2
    a = ab[..., :c]
    gathered = torch.gather(a, 1, idx.reshape(n, p * k, 1).expand(n, p * k, c))
    return gathered.reshape(n, p, k, c) + ab[..., None, c:]


def _transform(h, mean, rstd, scale, bias):
    """(xhat, pre-activation, y) of edge values h, each operation rounded
    as the kernels round it."""
    xhat = (h - mean) * rstd
    pre = xhat * scale + bias
    return xhat, pre, _leaky(pre)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def edge_conv_plain(ab, idx, mask, scale, bias, run_mean, run_var, *,
                    training: bool, momentum: float, eps: float):
    """Plain version of the kernels' forward: ab [N, P, 2C] (= [A, Bp]),
    idx int64 [N, P, k], mask bool [N, P] -> (out [N, P, C], saved f32[3C +
    1] = [mean, rstd, gate, count]); in training the running averages
    move."""
    edge_conv_plain.calls += 1
    k = idx.shape[-1]
    h = _edges(ab, idx)
    valid = mask[..., None, None]
    if training:
        hd = torch.where(valid, h.double(), 0.0)
        count = torch.clamp(mask.sum().double() * k, min=1.0)
        mean64 = hd.sum(dim=(0, 1, 2)) / count
        raw = (hd * hd).sum(dim=(0, 1, 2)) / count - mean64 * mean64
        mean = mean64.float()
        var = torch.clamp(raw, min=0.0).float()
        gate = (raw >= 0).float()
        with torch.no_grad():
            run_mean.mul_(momentum).add_((1 - momentum) * mean)
            run_var.mul_(momentum).add_((1 - momentum) * var)
    else:
        mean, var = run_mean, run_var
        count = torch.zeros((), dtype=torch.float64, device=mean.device)
        gate = torch.zeros_like(mean)
    rstd = 1.0 / torch.sqrt(var + eps)
    chosen = torch.where(scale >= 0, h.amax(dim=2), h.amin(dim=2))
    _, _, y = _transform(chosen, mean, rstd, scale, bias)
    out = torch.where(mask[..., None], y, 0.0)
    saved = torch.cat([mean, rstd, gate, count.float().reshape(1)])
    return out, saved


edge_conv_plain.calls = 0


def _shape(ab, idx, mask, c):
    n, p, k = idx.shape
    if ab.shape != (n, p, 2 * c) or mask.shape != (n, p):
        raise ValueError(f"edge_conv: ab {tuple(ab.shape)}, idx "
                         f"{tuple(idx.shape)}, mask {tuple(mask.shape)}, C={c}")
    if not 1 <= k <= min(p, MAX_K):
        raise ValueError(f"edge_conv: k={k} for P={p} (at most {MAX_K})")
    _check(ab, "ab", torch.float32, 3)
    _check(idx, "idx", torch.int64, 3)
    _check(mask, "mask", torch.bool, 2)
    return n, p, k


def _geometry(ab: torch.Tensor, rows: int, c: int):
    """(vec, threads, per_block, grid): the norm kernels' partition of the
    points, 4 channels a thread where C and the pointers allow."""
    vec = 4 if c % 4 == 0 and ab.data_ptr() % 16 == 0 else 1
    sms = torch.cuda.get_device_properties(ab.device).multi_processor_count
    return (vec, *norm_geometry(rows, c, vec, sms))


def _forward(ab, idx, mask, scale, bias, run_mean, run_var, *, training,
             momentum, eps):
    """The kernels' forward, or the plain version for CPU tensors."""
    if not _use_kernel(ab, idx, mask, scale, bias, run_mean, run_var):
        return edge_conv_plain(ab, idx, mask, scale, bias, run_mean, run_var,
                               training=training, momentum=momentum, eps=eps)
    c = scale.shape[0]
    n, p, k = _shape(ab, idx, mask, c)
    for name, t in (("scale", scale), ("bias", bias), ("run_mean", run_mean),
                    ("run_var", run_var)):
        _check(t, name, torch.float32, 1)
        if t.shape[0] != c:
            raise ValueError(f"edge_conv: {name} has {t.shape[0]} channels")
    vec, threads, per_block, grid = _geometry(ab, n * p, c)
    dev = ab.device
    chosen = torch.empty((n, p, c), dtype=torch.float32, device=dev)
    part = torch.empty((grid, 2 * c + 1), dtype=torch.float64, device=dev)
    stats = torch.empty(2 * c + 1, dtype=torch.float64, device=dev)
    out = torch.empty((n, p, c), dtype=torch.float32, device=dev)
    saved = torch.empty(3 * c + 1, dtype=torch.float32, device=dev)
    err = _native.lib("edge_conv").seid_edge_conv_fwd_f32(
        _ptr(ab), _ptr(idx), _ptr(mask.view(torch.uint8)), n, p, c, k, vec,
        threads, per_block, grid, _ptr(scale), _ptr(bias), _ptr(run_mean),
        _ptr(run_var), eps, momentum, 1.0 - momentum, int(bool(training)),
        SLOPE, _ptr(chosen), _ptr(part),
        _ptr(stats), _ptr(out), _ptr(saved), _stream(ab))
    edge_conv.launches += 1
    telemetry.count("edge_conv_fused")
    _native.check(err, "edge_conv")
    return out, saved


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def edge_conv_backward_plain(grad, ab, idx, mask, out, saved, scale, bias, *,
                             training: bool):
    """Plain version of the kernels' backward: grad [N, P, C] of the
    output -> (d ab [N, P, 2C] = [dA, dBp], f32[2C] = [sum dn, sum dn
    xhat]: the offset's and the scale's gradients)."""
    edge_conv_backward_plain.calls += 1
    n, p, k = idx.shape
    c = scale.shape[0]
    mean, rstd, gate, count = (saved[:c], saved[c:2 * c], saved[2 * c:3 * c],
                               saved[3 * c].double())
    h = _edges(ab, idx)
    xhat, pre, y = _transform(h, mean, rstd, scale, bias)
    valid = mask[..., None]
    tie = (y == out[:, :, None, :]) & valid[..., None]
    up = tie & (pre >= 0)
    down = tie & ~(pre >= 0)
    ties = tie.sum(dim=2).float()
    g = torch.where(valid & (ties > 0), grad / ties, 0.0)
    g_down = g * SLOPE
    d = up.sum(dim=2).float() * g + down.sum(dim=2).float() * g_down
    t = (g * torch.where(up, xhat, 0.0).sum(dim=2)
         + g_down * torch.where(down, xhat, 0.0).sum(dim=2))
    xsum = torch.where(valid, xhat.sum(dim=2), 0.0)
    s1 = d.double().sum(dim=(0, 1))
    s2 = t.double().sum(dim=(0, 1))
    a = scale * rstd
    if training:
        c1 = -(a * (s1 / count).float())
        c2 = -(a * (gate * (s2 / count).float()))
    else:
        c1 = c2 = torch.zeros_like(a)
    dbp = torch.where(valid, a * d + k * c1 + c2 * xsum, 0.0)
    dn = torch.where(up, g[:, :, None, :],
                     torch.where(down, g_down[:, :, None, :], 0.0))
    dh = a * dn + c1 + c2 * xhat
    base = (torch.arange(n, device=idx.device) * p)[:, None, None]
    edges = mask[..., None].expand(n, p, k)
    da = torch.zeros((n * p, c), dtype=torch.float32, device=ab.device)
    da.index_add_(0, (idx + base)[edges], dh[edges])
    dab = torch.cat([da.reshape(n, p, c), dbp], dim=-1)
    return dab, torch.cat([s1, s2]).float()


edge_conv_backward_plain.calls = 0


def reverse_index(idx: torch.Tensor, mask: torch.Tensor):
    """The edges of the valid points grouped by the point they point at:
    (keys int64 [N P k], each edge's neighbour as a global point index
    cloud P + point, ascending, N P for the padded points' edges, which
    sort last; edges int64 [N P k], the edge ids i k + s in that order,
    ascending within a neighbour; starts int64 [N P + 1], point j's edges
    being edges[starts[j]:starts[j + 1]]).  A stable sort: the same order
    on every run."""
    n, p, k = idx.shape
    base = (torch.arange(n, device=idx.device) * p)[:, None, None]
    key = torch.where(mask[..., None], idx + base, n * p).reshape(-1)
    keys, edges = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        keys, torch.arange(n * p + 1, device=idx.device, dtype=keys.dtype))
    return keys, edges, starts


def edge_conv_backward(grad, ab, idx, mask, out, saved, scale, bias, *,
                       training: bool):
    """The kernels' backward (see :func:`edge_conv_backward_plain`), or the
    plain version for CPU tensors."""
    if not _use_kernel(grad, ab, idx, mask, out, saved, scale, bias):
        return edge_conv_backward_plain(grad, ab, idx, mask, out, saved,
                                        scale, bias, training=training)
    c = scale.shape[0]
    n, p, k = _shape(ab, idx, mask, c)
    _check(grad, "grad", torch.float32, 3)
    _check(out, "out", torch.float32, 3)
    vec, threads, per_block, grid = _geometry(ab, n * p, c)
    if grad.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    keys, edges, starts = reverse_index(idx, mask)
    dev = ab.device
    scratch = torch.empty((3, n, p, c), dtype=torch.float32, device=dev)
    chunks = -(-n * p * k // CHUNK)
    partial = torch.empty((2, chunks, c), dtype=torch.float32, device=dev)
    part = torch.empty((grid, 2 * c), dtype=torch.float64, device=dev)
    sums64 = torch.empty(2 * c, dtype=torch.float64, device=dev)
    sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
    dab = torch.empty_like(ab)
    err = _native.lib("edge_conv").seid_edge_conv_bwd_f32(
        _ptr(grad), _ptr(ab), _ptr(idx), _ptr(mask.view(torch.uint8)),
        _ptr(out), _ptr(saved), _ptr(scale), _ptr(bias), n, p, c, k, vec,
        threads, per_block, grid, int(bool(training)), SLOPE, _ptr(keys),
        _ptr(edges), _ptr(starts), CHUNK, _ptr(partial[0]), _ptr(partial[1]),
        _ptr(scratch), _ptr(part), _ptr(sums64), _ptr(sums), _ptr(dab),
        _stream(ab))
    edge_conv_backward.launches += 1
    _native.check(err, "edge_conv_backward")
    return dab, sums


edge_conv_backward.launches = 0


# --------------------------------------------------------------------------
# the stage
# --------------------------------------------------------------------------

class _EdgeConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, scale, bias, idx, mask, run_mean, run_var,
                training, momentum, eps):
        f = x.shape[-1]
        wd = weight[:, :f]
        wcat = torch.cat([wd, weight[:, f:] - wd])  # [2C, F]: A, Bp
        ab = torch.matmul(x, wcat.t())
        out, saved = _forward(ab, idx, mask, scale, bias, run_mean, run_var,
                              training=training, momentum=momentum, eps=eps)
        ctx.save_for_backward(x, wcat, ab, idx, mask, out, saved, scale, bias)
        ctx.training = training
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, wcat, ab, idx, mask, out, saved, scale, bias = ctx.saved_tensors
        dab, sums = edge_conv_backward(grad.contiguous(), ab, idx, mask, out, saved,
                              scale, bias, training=ctx.training)
        c, f = scale.shape[0], x.shape[-1]
        dx = torch.matmul(dab, wcat) if ctx.needs_input_grad[0] else None
        dwcat = dab.reshape(-1, 2 * c).t() @ x.reshape(-1, f)
        dweight = torch.cat([dwcat[:c] - dwcat[c:], dwcat[c:]], dim=1)
        return (dx, dweight, sums[c:], sums[:c]) + (None,) * 7


def edge_conv(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              run_mean: torch.Tensor, run_var: torch.Tensor, *,
              training: bool, momentum: float, eps: float) -> torch.Tensor:
    """One edge-conv stage after its neighbour search: x [..., P, F] (any
    leading dims, computed in float32), idx int64 [..., P, k] (each point's
    neighbours in its own cloud), mask bool [..., P], weight [C, 2F] ->
    out f32 [..., P, C] (see the module's rule), differentiable in x,
    weight, scale and bias.  ``training``: the batch's statistics over the
    valid edges of every cloud, the running averages moved in place; else
    the running statistics."""
    lead, (p, f) = x.shape[:-2], x.shape[-2:]
    out = _EdgeConv.apply(x.float().reshape(-1, p, f).contiguous(), weight,
                          scale, bias,
                          idx.reshape(-1, p, idx.shape[-1]).contiguous(),
                          mask.reshape(-1, p).contiguous(), run_mean, run_var,
                          training, momentum, eps)
    return out.reshape(*lead, p, weight.shape[0])


edge_conv.launches = 0
