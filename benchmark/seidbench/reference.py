"""Plain PyTorch reference of the supervised train step that the benchmark
times, written from the published architecture (the sparse ResNet event
classifier of SparseEventID's recipes) and from nothing of the program.

From raw events and the weights the benchmark made, it derives the batch
(each projection's charge normalized to mean 1, std 0.5 as larcv's
Normalize does, cut at MaxVoxels in stored order, 2-D wire planes on a
(plane, y, x) grid), finds every sparse conv's neighbour pairs from the
coordinates by a sorted-key search, and runs the step in float32 with
TF32 off:

  initial k0^d submanifold conv 1 -> c0, then depth x [ series ; 2x
  strided conv + BN + leaky ], a final series, a 1x1 bottleneck + tanh,
  the mean over the full final grid, and per label a head
  fc1 -> dropout -> leaky(0.01) -> fc2; the focal loss (gamma 2) summed
  over the heads; the backward; AdamW (decoupled weight decay).

A series is ``blocks_per_layer`` residual blocks of two submanifold convs
(conv, batch norm over the batch's live sites, leaky; conv, batch norm;
+ input; leaky).  The dropout masks are drawn as the configuration states
them: ``torch.rand([B, hidden]) >= p`` for each head in label order, from
a generator seeded by the step's seed rule.

``precision`` rounds what the measured program keeps in its feature type
(inputs, conv weights and outputs, norms, activations, residual sums),
and the gradients that flow back through those points: an identity for
"float32"; a round trip through ``float8_e4m3fn`` (scaled per tensor) is
the control, the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LABEL_CLASSES = (("labelneutID", 3), ("labelprotID", 3), ("labelnpiID", 2),
                 ("labelcpiID", 2))
FP8_MAX = 448.0


# ---- the batch from raw events


def event_sites(projections, cfg: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """One event's level-0 sites -> (coords i64[n, 3], charge f32[n]).
    3-D: ids linear in the grid.  Wire planes: plane p's pixel id = y * W
    + x gives the site (p, y, x)."""
    grid = [int(g) for g in cfg["grid"]]
    max_voxels = int(cfg["max_voxels"])
    coords, values = [], []
    for p, (ids, vals) in enumerate(projections):
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        if cfg.get("normalize", True) and len(vals) > 1:
            vals = (vals - vals.mean()) / (vals.std() + 1e-6) * 0.5 + 1.0
        ids, vals = ids[:max_voxels], vals[:max_voxels]
        if int(cfg.get("planes", 1)) > 1:
            w = grid[2]
            c = np.stack([np.full(len(ids), p), ids // w, ids % w], -1)
        else:
            c = np.stack([ids // (grid[1] * grid[2]),
                          (ids // grid[2]) % grid[1], ids % grid[2]], -1)
        coords.append(c)
        values.append(vals)
    return np.concatenate(coords).astype(np.int64), np.concatenate(values)


def _lin(coords: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    return (coords[:, 0] * grid[1] + coords[:, 1]) * grid[2] + coords[:, 2]


@dataclasses.dataclass
class Level:
    """The live sites of one resolution: batch index, coordinates and the
    sorted keys b * volume + row-major index."""

    batch: torch.Tensor  # i64[n]
    coords: torch.Tensor  # i64[n, 3]
    keys: torch.Tensor  # i64[n], ascending
    grid: Tuple[int, ...]

    @property
    def volume(self) -> int:
        return int(np.prod(self.grid))


def make_level(batch: torch.Tensor, coords: torch.Tensor,
               grid: Sequence[int]) -> Tuple[Level, torch.Tensor]:
    """-> (the level sorted by key, the order that sorts the given rows)."""
    grid = tuple(int(g) for g in grid)
    keys = batch * int(np.prod(grid)) + _lin(coords, grid)
    keys, order = torch.sort(keys)
    return Level(batch[order], coords[order], keys, grid), order


def batch_input(events: List[Tuple[np.ndarray, np.ndarray]], grid,
                device) -> Tuple[Level, torch.Tensor]:
    """Events' (coords, charge) -> (level 0, charge f32[n] in key order)."""
    b = torch.cat([torch.full((len(c),), i, dtype=torch.int64)
                   for i, (c, _) in enumerate(events)])
    c = torch.from_numpy(np.concatenate([c for c, _ in events]))
    v = torch.from_numpy(np.concatenate([v for _, v in events]))
    level, order = make_level(b.to(device), c.to(device), grid)
    return level, v.to(device)[order]


def kernel_offsets(kernel: Sequence[int], centered: bool) -> np.ndarray:
    """Row-major offsets of a kernel: [-(k//2), k//2] per axis centred
    (submanifold), else [0, k) (strided); the weight's first axis."""
    ranges = [range(-(k // 2), k // 2 + 1) if centered else range(k)
              for k in kernel]
    return np.array(list(itertools.product(*ranges)), np.int64)


def _find(level: Level, batch: torch.Tensor, q: torch.Tensor):
    """Rows of ``level`` at (batch, q) -> (hit bool, row)."""
    g = torch.as_tensor(level.grid, device=q.device)
    inside = torch.all((q >= 0) & (q < g), dim=1)
    key = batch * level.volume + _lin(q.clamp(min=0), level.grid)
    pos = torch.searchsorted(level.keys, key).clamp(max=len(level.keys) - 1)
    return inside & (level.keys[pos] == key), pos


Pairs = List[Tuple[torch.Tensor, torch.Tensor]]  # per offset: (out, in)


def submanifold_pairs(level: Level, kernel: Sequence[int]) -> Pairs:
    """Per offset k: the (output row, input row) pairs with input = output
    + offset_k, sites unchanged."""
    rows = torch.arange(len(level.keys), device=level.keys.device)
    pairs = []
    for off in kernel_offsets(kernel, centered=True):
        hit, pos = _find(level, level.batch,
                         level.coords + torch.as_tensor(off, device=rows.device))
        pairs.append((rows[hit], pos[hit]))
    return pairs


def coarser(level: Level, stride: Sequence[int]) -> Level:
    """The sites of a strided conv: unique(coords // stride) on
    ceil(grid / stride)."""
    s = torch.as_tensor(stride, device=level.coords.device)
    grid = tuple(-(-g // int(st)) for g, st in zip(level.grid, stride))
    vol = int(np.prod(grid))
    keys = torch.unique(level.batch * vol + _lin(level.coords // s, grid))
    b, rem = keys // vol, keys % vol
    coords = torch.stack([rem // (grid[1] * grid[2]),
                          (rem // grid[2]) % grid[1], rem % grid[2]], 1)
    return Level(b, coords, keys, grid)


def downsample(level: Level, stride: Sequence[int]) -> Tuple[Level, Pairs]:
    """The coarser level and, per offset delta in [0, stride), the pairs
    (out, in) with in = out * stride + delta."""
    out = coarser(level, stride)
    s = torch.as_tensor(stride, device=level.coords.device)
    rows = torch.arange(len(out.keys), device=out.keys.device)
    pairs = []
    for off in kernel_offsets(stride, centered=False):
        hit, pos = _find(level, out.batch,
                         out.coords * s + torch.as_tensor(off, device=s.device))
        pairs.append((rows[hit], pos[hit]))
    return out, pairs


# ---- operations


class PairConv(torch.autograd.Function):
    """out[o] = sum_k x[i] @ w[k] over the offset-k pairs (o, i); the
    backward walks the same pairs (no pair repeats a row within an
    offset, so every scatter is a plain add)."""

    @staticmethod
    def forward(ctx, x, w, pairs, n_out):
        out = x.new_zeros((n_out, w.shape[2]))
        for k, (o, i) in enumerate(pairs):
            if len(o):
                out.index_add_(0, o, x[i] @ w[k])
        ctx.save_for_backward(x, w)
        ctx.pairs = pairs
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = torch.zeros_like(x)
        gw = torch.zeros_like(w)
        for k, (o, i) in enumerate(ctx.pairs):
            if len(o):
                g = gy[o]
                gx.index_add_(0, i, g @ w[k].T)
                gw[k] = x[i].T @ g
        return gx, gw, None, None


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A round trip of ``x`` through ``dtype``; fp8 scaled per tensor so
    its largest magnitude lands on the format's largest value."""
    if dtype == torch.float8_e4m3fn:
        amax = x.detach().abs().max()
        s = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
        return (x * s).to(dtype).to(x.dtype) / s
    return x.to(dtype).to(x.dtype)


class _RoundTrip(torch.autograd.Function):
    """Rounds the value in the forward and its gradient in the backward,
    as a cast to the feature type does in the program's autograd."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


def rounding(precision: str):
    """The rounding of the program's feature type in ``precision``."""
    if precision == "float32":
        return lambda x: x
    dtype = getattr(torch, precision)
    return lambda x: _RoundTrip.apply(x, dtype)


def batch_norm(x, scale, bias, eps):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


# ---- parameters


def filters(arch: Dict) -> List[int]:
    """Channels at each level 0..depth (additive growth)."""
    c0 = int(arch["n_initial_filters"])
    return [c0 * (1 + l) for l in range(int(arch["depth"]) + 1)]


def param_shapes(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter and running statistic, by the program's names."""
    k0 = int(np.prod(arch["initial_kernel"]))
    ks = int(np.prod(arch["series_kernel"]))
    kd = int(np.prod(arch["stride"]))
    ch = filters(arch)
    out = [("encoder.initial_w", (k0, 1, ch[0])),
           ("encoder.initial_b", (ch[0],)),
           ("encoder.bottleneck_w", (1, ch[-1], int(arch["n_output_filters"]))),
           ("encoder.bottleneck_b", (int(arch["n_output_filters"]),))]

    def norm(prefix, c):
        return [(f"{prefix}.norm.scale", (c,)), (f"{prefix}.norm.bias", (c,)),
                (f"{prefix}.norm.mean", (c,)), (f"{prefix}.norm.var", (c,))]

    def series(prefix, c):
        rows = []
        for blk in range(int(arch["blocks_per_layer"])):
            for conv in ("conv1", "conv2"):
                p = f"{prefix}.block_{blk}.{conv}"
                rows += [(f"{p}.w", (ks, c, c)), (f"{p}.b", (c,))] + norm(p, c)
        return rows

    for l in range(int(arch["depth"])):
        out += series(f"encoder.series_{l}", ch[l])
        out += [(f"encoder.down_{l}.w", (kd, ch[l], ch[l + 1]))]
        out += norm(f"encoder.down_{l}", ch[l + 1])
    out += series("encoder.final_series", ch[-1])
    hidden, c = int(arch["head_hidden"]), int(arch["n_output_filters"])
    for key, n in LABEL_CLASSES:
        p = f"head.{key}"
        out += [(f"{p}.fc1.weight", (hidden, c)), (f"{p}.fc1.bias", (hidden,)),
                (f"{p}.fc2.weight", (n, hidden)), (f"{p}.fc2.bias", (n,))]
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(".norm.mean") or name.endswith(".norm.var")


@torch.no_grad()
def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw of a generator seeded on
    ``device``, in float32: conv weights He-scaled over K * Cin, linear
    weights over their inputs, biases and norm offsets 0.1 N(0, 1), norm
    scales 1 + 0.1 N(0, 1); running statistics 0 and 1."""
    shapes = param_shapes(arch)
    total = sum(int(np.prod(s)) for n, s in shapes if not is_buffer(n))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in shapes:
        if name.endswith(".norm.mean"):
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.endswith(".norm.var"):
            out[name] = torch.ones(shape, device=device)
            continue
        n = int(np.prod(shape))
        t = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 3:  # sparse conv [K, Cin, Cout]
            t = t * (2.0 / (shape[0] * shape[1])) ** 0.5
        elif len(shape) == 2:  # linear [out, in]
            t = t / shape[1] ** 0.5
        elif name.endswith(".scale"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.clone()
    return out


# ---- the step


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout generator: seeded by (seed + 1, step) through
    numpy's SeedSequence, as the configuration's seed rule states."""
    entropy = np.random.SeedSequence([(int(seed) + 1) % 2**63, int(step)])
    return torch.Generator(device=device).manual_seed(
        int(entropy.generate_state(1, np.uint64)[0]))


def forward(w: Dict[str, torch.Tensor], level: Level, charge: torch.Tensor,
            n_events: int, arch: Dict, gen: Optional[torch.Generator],
            rnd) -> Dict[str, torch.Tensor]:
    """Logits by label of one training forward."""
    slope, eps = float(arch["leakiness"]), float(arch["bn_eps"])
    ch = filters(arch)

    def conv(x, name, pairs, n_out, bias=True):
        y = rnd(PairConv.apply(x, rnd(w[f"{name}.w"]), pairs, n_out))
        return rnd(y + w[f"{name}.b"]) if bias else y

    def bn_act(x, name, act=True):
        y = rnd(batch_norm(x, w[f"{name}.norm.scale"],
                           w[f"{name}.norm.bias"], eps))
        return rnd(F.leaky_relu(y, slope)) if act else y

    def series(x, prefix, pairs):
        n = x.shape[0]
        for blk in range(int(arch["blocks_per_layer"])):
            p = f"{prefix}.block_{blk}"
            y = bn_act(conv(x, f"{p}.conv1", pairs, n), f"{p}.conv1")
            y = bn_act(conv(y, f"{p}.conv2", pairs, n), f"{p}.conv2", act=False)
            x = rnd(F.leaky_relu(rnd(y + x), slope))
        return x

    x = rnd(charge[:, None])
    pairs = submanifold_pairs(level, arch["initial_kernel"])
    x = rnd(PairConv.apply(x, rnd(w["encoder.initial_w"]), pairs, len(x)))
    x = rnd(x + w["encoder.initial_b"])
    for l in range(int(arch["depth"])):
        x = series(x, f"encoder.series_{l}",
                   submanifold_pairs(level, arch["series_kernel"]))
        level, pairs = downsample(level, arch["stride"])
        x = bn_act(conv(x, f"encoder.down_{l}", pairs, len(level.keys),
                        bias=False), f"encoder.down_{l}")
    x = series(x, "encoder.final_series",
               submanifold_pairs(level, arch["series_kernel"]))
    x = torch.tanh(x @ w["encoder.bottleneck_w"][0] + w["encoder.bottleneck_b"])
    pooled = torch.zeros((n_events, x.shape[1]), device=x.device)
    pooled = pooled.index_add(0, level.batch, x) / level.volume
    p = float(arch["head_dropout"])
    logits = {}
    for key, _n in LABEL_CLASSES:
        h = F.linear(pooled, w[f"head.{key}.fc1.weight"], w[f"head.{key}.fc1.bias"])
        if p > 0:
            keep = torch.rand(h.shape, generator=gen, device=h.device) >= p
            h = h * keep / (1.0 - p)
        h = F.leaky_relu(h, float(arch["head_leakiness"]))
        logits[key] = F.linear(h, w[f"head.{key}.fc2.weight"],
                               w[f"head.{key}.fc2.bias"])
    return logits


def focal_loss(logits, labels, gamma: float, clamp: float):
    y = F.one_hot(labels.long(), logits.shape[-1]).float()
    p = torch.softmax(logits, -1).clamp(clamp, 1.0 - clamp)
    return (-y * torch.log(p) * (1.0 - p) ** gamma).sum(-1)


def learning_rate(opt: Dict, step: int, epoch_length: int) -> float:
    """The warm-up part of the schedule: linear from ``warmup_start`` to
    the peak over the first epoch, in float32."""
    if step >= epoch_length:
        raise ValueError("the reference follows the warm-up epoch only")
    f = np.float32
    start, peak = f(opt["warmup_start"]), f(opt["peak_lr"])
    return float(start + f(step) * f(peak - start) / f(epoch_length))


@dataclasses.dataclass
class Readings:
    """What the reference gives for the checked steps: each step's loss,
    each parameter's first gradient norm, its change over the steps, and
    each batch's input (sorted level-0 coordinates and charge)."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    inputs: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def train_steps(cfg: Dict, weights: Dict[str, torch.Tensor],
                batches: List[Tuple[List, Dict[str, np.ndarray]]],
                run_seed: int, epoch_length: int, device,
                precision: str = "float32", variant: str = "") -> Readings:
    """Run ``len(batches)`` steps from ``weights``; batch k is (events'
    projections, labels by key) and takes step k's dropout generator and
    learning rate.  ``variant`` plants a fault for the harness's checks:
    "half" takes the loss over the first half of each batch, "alter"
    doubles event 0's first charge of each batch."""
    arch, opt, loss_cfg = cfg["arch"], cfg["optimizer"], cfg["loss"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = rounding(precision)
    names = [n for n, _ in param_shapes(arch) if not is_buffer(n)]
    p = {n: weights[n].detach().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    eps, wd = float(opt["eps"]), float(opt["weight_decay"])
    losses, grad_norms, inputs = [], {}, []
    try:
        for step, (events, labels) in enumerate(batches):
            sites = [event_sites(ev, cfg) for ev in events]
            if variant == "alter":
                coords, charge = sites[0]
                charge = charge.copy()
                charge[0] *= 2.0
                sites[0] = (coords, charge)
            level, charge = batch_input(sites, cfg["grid"], device)
            inputs.append((level.batch, level.coords, rnd(charge).detach()))
            gen = dropout_generator(run_seed, step, device)
            logits = forward(p, level, charge, len(events), arch, gen, rnd)
            keep = len(events) // 2 if variant == "half" else len(events)
            loss = sum(
                focal_loss(logits[k][:keep],
                           torch.as_tensor(labels[k][:keep], device=device),
                           float(loss_cfg["gamma"]),
                           float(loss_cfg["clamp"])).mean()
                for k, _n in LABEL_CLASSES)
            for t in p.values():
                t.grad = None
            loss.backward()
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(p[n].grad))
                              for n in names}
            lr = learning_rate(opt, step, epoch_length)
            with torch.no_grad():
                t = step + 1
                for n in names:
                    g = p[n].grad
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p[n].mul_(1 - lr * wd)
                    denom = (v[n].sqrt() / (1 - b2**t) ** 0.5).add_(eps)
                    p[n].addcdiv_(m[n], denom, value=-lr / (1 - b1**t))
        change = {n: float(torch.linalg.vector_norm(p[n].detach() - weights[n]))
                  for n in names}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return Readings(losses, grad_norms, change, inputs)
