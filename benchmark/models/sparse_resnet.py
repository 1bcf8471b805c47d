"""The sparse ResNet event classifier of SparseEventID's recipes (dune3d,
dune2d): the benchmark's model family ``sparse_resnet``.

A thin module over ``seidbench/reference.py`` (the batch from the raw
events, the neighbour pairs, the forward, the parameters) and
``seidbench/flops.py`` (the work of a step, counted from the sites).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from seidbench import flops, reference


def param_shapes(cfg: Dict):
    """The trained parameters, by the program's names: every parameter but
    the batch norms' running statistics."""
    return [(n, s) for n, s in reference.param_shapes(cfg["arch"])
            if not reference.is_buffer(n)]


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return reference.make_weights(cfg["arch"], seed, device)


def reference_batch(events, cfg: Dict, device, rnd, alter: bool = False):
    """-> ((level 0, charge in key order), (batch index, coordinates, the
    charge as the program keeps it)).  ``alter`` doubles event 0's first
    charge where the batch is made."""
    sites = [reference.event_sites(ev, cfg) for ev in events]
    if alter:
        coords, charge = sites[0]
        charge = charge.copy()
        charge[0] *= 2.0
        sites[0] = (coords, charge)
    level, charge = reference.batch_input(sites, cfg["grid"], device)
    return (level, charge), (level.batch, level.coords, rnd(charge).detach())


def forward(weights, model_input, n_events: int, cfg: Dict, generator, rnd):
    level, charge = model_input
    return reference.forward(weights, level, charge, n_events, cfg["arch"],
                             generator, rnd)


def program_input(args):
    """(batch index, coords, charge) of the live rows of the program's
    prepared SparseTensor, in its key order."""
    st = args[0]
    n = st.n_active.cpu().tolist()
    b = torch.cat([torch.full((k,), i, dtype=torch.int64)
                   for i, k in enumerate(n)])
    c = torch.cat([st.coords[i, :k].cpu().long() for i, k in enumerate(n)])
    v = torch.cat([st.feats[i, :k, 0].float().cpu() for i, k in enumerate(n)])
    return b, c, v


def gradient_leaves(names: Sequence[str]) -> List[str]:
    """The encoder's conv weights (``*_w``, ``*.w``); batch-norm scales are
    not among them."""
    return [n for n in names if n.startswith("encoder.")
            and (n.endswith("_w") or n.endswith(".w"))]


def window_work(cfg: Dict, pool_events, window_batches, peak: Dict,
                device) -> Dict[str, float]:
    """``useful_flop``: useful operations of the window's batches (read by
    ``mfu.train``); ``conv_roofline_s``: the sparse convs' least time on
    them (read by ``conv_roofline.train``)."""
    used = sorted({int(i) for rows in window_batches for i in rows})
    where = {e: r for r, e in enumerate(used)}
    sites = [reference.event_sites(pool_events[e], cfg)[0] for e in used]
    counts = flops.event_counts(sites, cfg["arch"], cfg["grid"], device)
    macs = flops.useful_macs(counts, cfg["arch"])
    return {
        "useful_flop": float(sum(
            2.0 * macs[[where[int(i)] for i in rows]].sum()
            for rows in window_batches)),
        "conv_roofline_s": float(sum(
            flops.conv_roofline_s(counts, [where[int(i)] for i in rows],
                                  cfg["arch"], peak["bf16_flops"],
                                  peak["hbm_bytes_per_s"])
            for rows in window_batches)),
    }


def check_program(cfg: Dict) -> None:
    """The configuration states what the program loads from its recipe,
    and the reference's parameters and statistics are the program's."""
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.models import build_sparse_classifier

    prog = load_config(cfg["recipe"], cfg["overrides"])
    enc, arch = prog.encoder, cfg["arch"]
    for key in ("depth", "n_initial_filters", "n_output_filters",
                "blocks_per_layer", "filter_size", "leakiness"):
        assert getattr(enc, key) == arch[key], key
    assert prog.data.max_voxels == cfg["max_voxels"]
    assert prog.head.hidden == arch["head_hidden"]
    assert prog.head.dropout == arch["head_dropout"]
    assert prog.mode.optimizer.weight_decay == cfg["optimizer"]["weight_decay"]
    sched = prog.mode.optimizer.lr_schedule
    assert sched.peak_learning_rate == cfg["optimizer"]["peak_lr"]
    model = build_sparse_classifier(prog)
    ik, sks, stride = model.encoder.plan_kernels()
    assert list(ik) == arch["initial_kernel"]
    assert list(sks[0]) == arch["series_kernel"]
    assert list(stride) == arch["stride"]
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert shapes == dict(reference.param_shapes(arch))
