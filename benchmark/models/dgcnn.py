"""The dynamic graph CNN classifier (Wang et al., "Dynamic Graph CNN for
Learning on Point Clouds", arXiv:1801.07829; SparseEventID's
``src/networks/torch/dgcnn3d.py``) on the first points of each event: the
benchmark's model family ``dgcnn``.

The reference, written from the published description in plain float32
PyTorch with TF32 off, from nothing of the program: four EdgeConv stages
(64, 64, 128, 256), each finding the k = 20 nearest neighbours of every
point in the stage's own input features, forming the edge features
(x_j - x_i, x_i), a shared Dense without bias, a batch norm over the edges
of the valid points, leaky ReLU 0.2 and the max over the neighbours; the
stages concatenated, a Dense to 1024 without bias, a batch norm over the
valid points, leaky ReLU 0.2; the masked max and the masked mean over the
points concatenated; per label FC 512, leaky ReLU 0.2, dropout 0.5, FC 256,
leaky ReLU 0.2, FC n.

Departures from the paper, as SparseEventID and the port have them:
- the pooling is a masked max and a masked mean over the valid points (the
  paper's global max and average pooling over every point of a full cloud);
- the heads are per label (four of them), each FC 512 -> dropout -> FC 256
  -> FC n, with leaky ReLU 0.2 after both hidden layers and no batch norm;
- the first layer's Dense has no batch norm of its own beyond the EdgeConv's
  (as the paper's);
- an event is cut to its first ``max_points`` valid voxels in the order the
  loader lays them out (the events of this benchmark hold 32-36k voxels).

The neighbour search follows the published code's rule, squared distance
|x_i|^2 - 2 <x_i, x_j> + |x_j|^2 by a matrix product, a padded candidate at
1e9, a stable sort of each row (equal distances keep the lower index),
with one departure: the distances are computed in float64, so that the
order is the exact one (in float32 the first stage's raw coordinates, up
to 1280, round |x|^2 to about 0.25, and a search picks among near-tied
neighbours by its own rounding).  It runs a few events at a time, without
autograd, so that the [P, P] distances of only those events exist at
once.

``rnd`` rounds what a program in that precision would keep in it: the
points, each Dense's input, weight and output, each norm's and each
activation's output (the heads compute in float32, as the program's).
The input reading: (batch index, integer coordinates, charge) of the kept
points, ordered by (batch, coordinates).  ``window_work`` adds to the traced
run's record ``useful_flop`` (each edge Dense's 2 B P k 2F_in F_out, the
embedding's and the heads' operations, all x3 for forward, dX and dW, and
the search's 2 B P^2 F once), ``knn_roofline_s`` (per stage the larger of
the search's operations over the card's float32 peak and its bytes over the
memory bandwidth, read by ``knn_roofline.train``) and ``useful_fp32_s``
(``useful_flop`` over the float32 peak, read by ``mfu_fp32.train``).  The
float32 peak is not in ``peaks.json``: it is ``FP32_FLOPS`` below, by
``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from seidbench import reference

# dense float32 outside the tensor cores, by the card's name
FP32_FLOPS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 66.9e12,
        "source": "NVIDIA H100 data sheet, SXM part, FP32 66.9 TFLOPS"},
}
KNN_EVENTS = 2  # events whose [P, P] distances the search holds at once


def _stages(arch: Dict):
    """(input features, output features) of each EdgeConv stage."""
    c, out = int(arch["in_features"]), []
    for f in arch["stage_dims"]:
        out.append((c, int(f)))
        c = int(f)
    return out


def _shapes(arch: Dict):
    """Every parameter and running statistic, by the program's names."""
    def norm(prefix, c):
        return [(f"{prefix}.scale", (c,)), (f"{prefix}.bias", (c,)),
                (f"{prefix}.mean", (c,)), (f"{prefix}.var", (c,))]

    out = []
    for i, (cin, cout) in enumerate(_stages(arch)):
        out += [(f"inner.edge{i}.fc.weight", (cout, 2 * cin))]
        out += norm(f"inner.edge{i}.bn", cout)
    emb = int(arch["emb_dims"])
    stages = sum(int(f) for f in arch["stage_dims"])
    out += [("inner.emb.weight", (emb, stages))]
    out += norm("inner.emb_bn", emb)
    fc1, hidden = int(arch["head_fc1"]), int(arch["head_hidden"])
    for key, n in reference.LABEL_CLASSES:
        p = f"inner.{key}"
        out += [(f"{p}_fc1.weight", (fc1, 2 * emb)), (f"{p}_fc1.bias", (fc1,)),
                (f"{p}_fc2.weight", (hidden, fc1)),
                (f"{p}_fc2.bias", (hidden,)),
                (f"{p}_out.weight", (n, hidden)), (f"{p}_out.bias", (n,))]
    return out


def _is_buffer(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def param_shapes(cfg: Dict):
    """The trained parameters: every one but the norms' running
    statistics."""
    return [(n, s) for n, s in _shapes(cfg["arch"]) if not _is_buffer(n)]


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw of a generator seeded on
    ``device``, in float32: linear weights over the square root of their
    inputs, biases and norm offsets 0.1 N(0, 1), norm scales 1 + 0.1 N(0,
    1); running statistics 0 and 1."""
    shapes = _shapes(cfg["arch"])
    total = sum(int(np.prod(s)) for n, s in shapes if not _is_buffer(n))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in shapes:
        if name.endswith(".mean"):
            out[name] = torch.zeros(shape, device=device)
            continue
        if name.endswith(".var"):
            out[name] = torch.ones(shape, device=device)
            continue
        n = int(np.prod(shape))
        t = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 2:
            t = t / shape[1] ** 0.5
        elif name.endswith(".scale"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.clone()
    return out


# ---- the batch and its reading


def _reading(b, c, v):
    """(batch, coordinates, charge) rows in (batch, coordinates) order;
    coordinates under 4096 on each axis, as every grid of the
    benchmark's."""
    key = ((b * 4096 + c[:, 0]) * 4096 + c[:, 1]) * 4096 + c[:, 2]
    order = torch.argsort(key)
    return b[order], c[order], v[order]


def reference_batch(events, cfg: Dict, device, rnd, alter: bool = False):
    """-> ((points f32[B, P, 4], mask bool[B, P]) in the loader's order,
    the input reading).  Each event's voxels are normalised as the loader
    does and cut to the first ``max_points``; ``alter`` doubles event 0's
    first charge where the batch is made."""
    p = int(cfg["arch"]["max_points"])
    sites = [reference.event_sites(ev, cfg) for ev in events]
    if alter:
        coords, charge = sites[0]
        charge = charge.copy()
        charge[0] *= 2.0
        sites[0] = (coords, charge)
    pts = np.zeros((len(events), p, 4), np.float32)
    mask = np.zeros((len(events), p), bool)
    for i, (coords, charge) in enumerate(sites):
        n = min(len(coords), p)
        pts[i, :n, :3] = coords[:n]
        pts[i, :n, 3] = charge[:n]
        mask[i, :n] = True
    pts_t = torch.from_numpy(pts).to(device)
    mask_t = torch.from_numpy(mask).to(device)
    b = torch.nonzero(mask_t)[:, 0]
    kept = pts_t[mask_t]
    reading = _reading(b.cpu(), kept[:, :3].long().cpu(),
                       rnd(kept[:, 3]).detach().cpu())
    return (pts_t, mask_t), reading


def program_input(args):
    """(batch index, coords, charge) of the program's prepared points
    (``args[0]`` = (points, mask)), ordered by (batch, coordinates)."""
    pts, mask = args[0]
    b = torch.nonzero(mask)[:, 0].cpu()
    kept = pts[mask].float().cpu()
    return _reading(b, kept[:, :3].long(), kept[:, 3])


# ---- the forward


@torch.no_grad()
def knn(x: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, P, F] -> int64 [B, P, k]: each point's k nearest valid points,
    itself included, by distances in float64, a few events at a time."""
    out = []
    for s in range(0, x.shape[0], KNN_EVENTS):
        xe, me = x[s:s + KNN_EVENTS].double(), mask[s:s + KNN_EVENTS]
        sq = (xe * xe).sum(-1)
        d = sq[:, :, None] - 2.0 * torch.bmm(xe, xe.transpose(1, 2)) \
            + sq[:, None, :]
        d = torch.where(me[:, None, :], d, 1e9)
        out.append(torch.sort(d, dim=-1, stable=True).indices[..., :k])
        del d
    return torch.cat(out)


def _norm(h, valid, w, prefix, eps):
    """Batch norm of h [..., C] over its rows where ``valid``, the rest 0."""
    rows = h[valid]
    mean = rows.mean(0)
    var = ((rows - mean) ** 2).mean(0)
    out = (h - mean) * torch.rsqrt(var + eps) * w[f"{prefix}.scale"] \
        + w[f"{prefix}.bias"]
    return torch.where(valid[..., None], out, 0.0)


def forward(weights, model_input, n_events: int, cfg: Dict, generator, rnd):
    """Logits by label of one training forward."""
    arch, w = cfg["arch"], weights
    pts, mask = model_input
    k, eps = int(arch["k"]), float(arch["bn_eps"])
    slope = float(arch["leakiness"])
    x = rnd(pts)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    stages = []
    for i in range(len(arch["stage_dims"])):
        idx = knn(x.detach(), mask, k)
        xj = x[b, idx]  # [B, P, k, F]
        xi = x[:, :, None, :].expand_as(xj)
        e = rnd(torch.cat([xj - xi, xi], dim=-1))
        h = rnd(e @ rnd(w[f"inner.edge{i}.fc.weight"]).T)
        edges = mask[:, :, None].expand(h.shape[:-1])
        h = rnd(_norm(h, edges, w, f"inner.edge{i}.bn", eps))
        h = rnd(F.leaky_relu(h, slope))
        x = torch.where(mask[..., None], h.amax(dim=-2), 0.0)
        stages.append(x)
    h = rnd(rnd(torch.cat(stages, dim=-1)) @ rnd(w["inner.emb.weight"]).T)
    h = rnd(F.leaky_relu(rnd(_norm(h, mask, w, "inner.emb_bn", eps)), slope))
    m = mask[..., None].float()
    gmax = torch.where(mask[..., None], h, -1e9).amax(dim=-2)
    gavg = (h * m).sum(dim=-2) / m.sum(dim=-2).clamp(min=1.0)
    emb = torch.cat([gmax, gavg], dim=-1)
    p = float(arch["head_dropout"])
    logits = {}
    for key, _n in reference.LABEL_CLASSES:
        pre = f"inner.{key}"
        h = F.leaky_relu(F.linear(emb, w[f"{pre}_fc1.weight"],
                                  w[f"{pre}_fc1.bias"]), slope)
        if p > 0:
            keep = torch.rand(h.shape, generator=generator,
                              device=h.device) >= p
            h = h * keep / (1.0 - p)
        h = F.leaky_relu(F.linear(h, w[f"{pre}_fc2.weight"],
                                  w[f"{pre}_fc2.bias"]), slope)
        logits[key] = F.linear(h, w[f"{pre}_out.weight"], w[f"{pre}_out.bias"])
    return logits


def gradient_leaves(names: Sequence[str]) -> List[str]:
    """The four EdgeConv Dense weights and the embedding's: a fault in one
    stage's backward moves its own weight's gradient."""
    return [n for n in names if n == "inner.emb.weight"
            or (n.startswith("inner.edge") and n.endswith(".fc.weight"))]


# ---- the work of a window


def work_of(points: Sequence[int], arch: Dict, fp32_flops: float,
            hbm_bytes_per_s: float) -> Dict[str, float]:
    """The useful operations, the search's least time and the whole step's
    least time at the float32 peak, for one step over events of
    ``points`` valid points each."""
    k, emb = int(arch["k"]), int(arch["emb_dims"])
    fc1, hidden = int(arch["head_fc1"]), int(arch["head_hidden"])
    n = [int(p) for p in points]
    flop = knn_s = 0.0
    for cin, cout in _stages(arch):
        flop += 3 * 2.0 * sum(n) * k * 2 * cin * cout
        search = 2.0 * sum(p * p for p in n) * cin
        flop += search
        moved = sum(p * (cin * 4 + 1 + k * 8) for p in n)
        knn_s += max(search / fp32_flops, moved / hbm_bytes_per_s)
    flop += 3 * 2.0 * sum(n) * sum(int(f) for f in arch["stage_dims"]) * emb
    heads = sum(2 * emb * fc1 + fc1 * hidden + hidden * c
                for _, c in reference.LABEL_CLASSES)
    flop += 3 * 2.0 * len(n) * heads
    return {"useful_flop": flop, "knn_roofline_s": knn_s,
            "useful_fp32_s": flop / fp32_flops}


def window_work(cfg: Dict, pool_events, window_batches, peak: Dict,
                device) -> Dict[str, float]:
    """The sums of ``work_of`` over the window's batches; nothing where the
    card's float32 peak is not known."""
    name = (torch.cuda.get_device_name(device)
            if torch.device(device).type == "cuda" else "cpu")
    fp32 = FP32_FLOPS.get(name, {}).get("fp32_flops")
    if fp32 is None:
        return {}
    arch = cfg["arch"]
    cap = int(arch["max_points"])
    used = sorted({int(i) for rows in window_batches for i in rows})
    points = {e: min(len(reference.event_sites(pool_events[e], cfg)[0]), cap)
              for e in used}
    total: Dict[str, float] = {}
    for rows in window_batches:
        for key, v in work_of([points[int(i)] for i in rows], arch, fp32,
                              peak["hbm_bytes_per_s"]).items():
            total[key] = total.get(key, 0.0) + v
    return total


def check_program(cfg: Dict) -> None:
    """The configuration states what the program loads from its recipe and
    overrides, and the reference's parameters and statistics are the
    program's."""
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.models import build_model

    prog = load_config(cfg["recipe"], cfg["overrides"])
    enc, arch = prog.encoder, cfg["arch"]
    assert type(enc).__name__ == "DGCNNRepresentation", type(enc).__name__
    assert enc.k == arch["k"] == 20
    assert enc.emb_dims == arch["emb_dims"] == 1024
    assert enc.max_points == arch["max_points"] == 8192
    assert prog.head.hidden == arch["head_hidden"] == 256
    assert prog.head.dropout == arch["head_dropout"] == 0.5
    assert prog.run.precision.name == cfg["precision"] == "float32"
    assert list(arch["stage_dims"]) == [64, 64, 128, 256]
    assert prog.data.max_voxels == cfg["max_voxels"]
    assert prog.data.dimension + 1 == arch["in_features"]
    assert prog.mode.optimizer.weight_decay == cfg["optimizer"]["weight_decay"]
    sched = prog.mode.optimizer.lr_schedule
    assert sched.peak_learning_rate == cfg["optimizer"]["peak_lr"]
    model, mode = build_model(prog)
    assert mode == "points"
    assert [getattr(model.inner, f"edge{i}").n_out
            for i in range(model.inner.n_stages)] == arch["stage_dims"]
    assert all(getattr(model.inner, f"edge{i}").k == arch["k"]
               for i in range(model.inner.n_stages))
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert shapes == dict(_shapes(arch))
