"""The ranks of the port's data-parallel tests: spawned processes that
import torch, numpy and the port, never JAX.

``run_ranks(job, world, tmp_path, *args)`` starts ``world`` processes, each
joining a gloo group through a ``file://`` store under ``tmp_path`` on one
torch thread, and runs ``job(rank, world, *args)`` there; each rank's
return value comes back through ``torch.save``.  The ranks are joined with a
time limit and killed when it passes; a rank that fails or times out fails
the call.
"""

from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

JOIN_S = 150  # a whole run of ranks, spawn and imports included


def run_ranks(job, world, tmp_path, *args):
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(job, r, world, str(store), str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks still ran after {JOIN_S} s")
    errors = [(tmp / f"error_{r}.txt") for r in range(world)]
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            text = errors[r].read_text() if errors[r].exists() else ""
            raise RuntimeError(f"rank {r} exited with {p.exitcode}\n{text}")
    return [torch.load(tmp / f"result_{r}.pt", weights_only=False) for r in range(world)]


def _entry(job, rank, world, store, tmp, args):
    import torch.distributed as dist

    from sparseeventid_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        result = job(rank, world, *args)
        mesh.destroy()
    except BaseException:
        Path(tmp, f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    torch.save(result, Path(tmp, f"result_{rank}.pt"))


def digest(module: torch.nn.Module) -> str:
    """One hash of every parameter's and buffer's bits, in state_dict order."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---- (a) sync batch-norm statistics, (b) NT-Xent -------------------------

def stats_inputs():
    """Per-rank feats [2, 48, 6], masks with unequal live counts (rank 0
    holds an empty event) and per-rank loss weights (c, d) of the stats."""
    rng = np.random.default_rng(11)
    live = [(30, 0), (17, 40)]
    feats, masks = [], []
    for counts in live:
        mask = np.zeros((2, 48), bool)
        for b, n in enumerate(counts):
            mask[b, :n] = True
        f = rng.standard_normal((2, 48, 6)).astype(np.float32) * 1.5 + 0.3
        feats.append(f * mask[..., None])
        masks.append(mask)
    weights = rng.standard_normal((2, 2, 6)).astype(np.float32)
    return np.stack(feats), np.stack(masks), weights


def nt_xent_inputs():
    rng = np.random.default_rng(12)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.standard_normal((8, 16)).astype(np.float32))


def stats_and_nt_xent_job(rank, world):
    """(a) and (b) on this rank's rows: stats, their loss's gradient wrt
    feats; the NT-Xent loss and its gradient wrt z1 and z2."""
    from sparseeventid_tpu_torch.ops.norm import masked_batch_stats
    from sparseeventid_tpu_torch.train.losses import nt_xent_loss

    feats, masks, weights = stats_inputs()
    f = torch.from_numpy(feats[rank]).requires_grad_(True)
    mean, var = masked_batch_stats(f, torch.from_numpy(masks[rank]), sync=True)
    c, d = torch.from_numpy(weights[rank])
    ((mean * c).sum() + (var * d).sum()).backward()
    z1, z2 = nt_xent_inputs()
    n = z1.shape[0] // world
    z1 = torch.from_numpy(z1[rank * n:(rank + 1) * n]).requires_grad_(True)
    z2 = torch.from_numpy(z2[rank * n:(rank + 1) * n]).requires_grad_(True)
    loss = nt_xent_loss(z1, z2, 0.1, sync=True)
    loss.backward()
    return dict(mean=mean.detach(), var=var.detach(), grad=f.grad,
                nt_loss=float(loss.detach()), g1=z1.grad, g2=z2.grad)


# ---- (c), (d), (e) one supervised step -------------------------------------

GRID = (16, 16, 16)
STEP_OVERRIDES = [
    "data=synthetic", "encoder.depth=2", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=16", "encoder.n_output_filters=16",
    "run.minibatch_size=2", "framework.min_capacity=64", "head.dropout=0.0",
    "head.hidden=32", "mode.optimizer.lr_schedule=flat",
    "mode.optimizer.lr_schedule.peak_learning_rate=0.003",
    "framework.sparse_backend=xla", "run.compute_mode=CPU",
]


def step_config(distributed: bool):
    from sparseeventid_tpu_torch.config import load_config

    cfg = load_config("synthetic", STEP_OVERRIDES
                      + [f"run.distributed={str(distributed).lower()}"])
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_voxels=256))


def step_batch():
    """Four events, two a rank."""
    from sparseeventid_tpu_torch.io import SyntheticDataset, SyntheticEventConfig

    ds = SyntheticDataset(8, SyntheticEventConfig(image_size=GRID, max_voxels=256),
                          seed=3)
    return ds.batch([0, 1, 2, 3])


def supervised_step(state_dict, batch, distributed: bool):
    """One supervised train step of the port from ``state_dict`` on
    ``batch`` -> (metrics, model after the step, the gradients the optimizer
    was given)."""
    from sparseeventid_tpu_torch.config.schema import OUTPUT_SHAPE, LossBalanceScheme
    from sparseeventid_tpu_torch.io.transforms import larcv_batch_to_sparse_3d
    from sparseeventid_tpu_torch.models import build_sparse_classifier
    from sparseeventid_tpu_torch.train import (
        TrainState,
        build_lr_schedule,
        build_optimizer,
        make_train_step,
    )

    cfg = step_config(distributed)
    model = build_sparse_classifier(cfg, sync_bn=distributed)
    model.load_state_dict(state_dict)
    opt_cfg = cfg.mode.optimizer
    sched = build_lr_schedule(opt_cfg.lr_schedule, 4, 1)
    optimizer, scheduler = build_optimizer(opt_cfg, sched, model.parameters())
    grads = {}
    update = optimizer.step

    def spy(*a, **k):  # the gradients as the optimizer receives them
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return update(*a, **k)

    optimizer.step = spy
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(state, LossBalanceScheme.focal, sched)
    st = larcv_batch_to_sparse_3d(batch["image"], GRID, capacity=512)
    labels = {k: torch.from_numpy(batch[k]) for k in OUTPUT_SHAPE}
    metrics = step(st, labels, torch.Generator().manual_seed(5))
    return {k: float(v) for k, v in metrics.items()}, model, grads


def _rank_rows(batch, rank, world):
    n = len(batch["image"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def dp_step_job(rank, world, state_path):
    """(c), (d): the 2-rank step on this rank's two events."""
    batch = _rank_rows(step_batch(), rank, world)
    metrics, model, grads = supervised_step(torch.load(state_path), batch, True)
    return dict(metrics=metrics, grads=grads, digest=digest(model))


def world1_job(rank, world, state_path):
    """(e): the same step in a group of one and with no group."""
    from sparseeventid_tpu_torch.parallel import mesh

    sd, batch = torch.load(state_path), step_batch()
    out = {}
    for label in ("group", "none"):
        metrics, model, grads = supervised_step(sd, batch, True)
        out[label] = dict(metrics=metrics, grads=grads, state=model.state_dict())
        mesh.destroy()
    return out


# ---- (f) train and validate through the entry points -----------------------

TINY = [
    "encoder.depth=2", "encoder.blocks_per_layer=1",
    "encoder.n_initial_filters=8", "encoder.n_output_filters=16",
    "framework.min_capacity=64", "run.minibatch_size=2",
    "run.compute_mode=CPU", "mode.checkpoint_iteration=100",
    "data.max_voxels=256", "head.hidden=32",
    "framework.sparse_backend=window",
]


def entry_points_job(rank, world, out_dir):
    """(f): train 2 steps, resume to 4, an odd-sized split's epoch, yolo
    inference, the softmax file and 2 steps of every task through the
    command line's entry, all with run.distributed=true."""
    from sparseeventid_tpu_torch.__main__ import main
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.train import trainer
    from sparseeventid_tpu_torch.train.evaluate import validate
    from sparseeventid_tpu_torch.train.tasks import TASKS
    from sparseeventid_tpu_torch.utils.checkpoint import CheckpointManager

    shards, writes = {}, []
    make_loader, write = trainer.make_loader, CheckpointManager._write

    def spy_loader(cfg, dataset, transform=None):
        loader = make_loader(cfg, dataset, transform)
        shards.setdefault(cfg.run.id, []).append(loader.indices.tolist())
        return loader

    def spy_write(self, state, path):
        writes.append(path.name)
        return write(self, state, path)

    trainer.make_loader, CheckpointManager._write = spy_loader, spy_write

    def cfg(run_id, *extra):
        return load_config("synthetic", TINY + [
            "run.distributed=true", f"output_dir={out_dir}", f"run.id={run_id}",
            "data.synthetic_events=8", *extra])

    first = trainer.train(cfg("dp", "mode.iterations=2"))
    resumed = trainer.train(cfg("dp", "mode.iterations=4"))
    odd = trainer.train(cfg("odd", "mode.iterations=0", "data.synthetic_events=7",
                            "data.active=[train]"))
    yolo = main(["--config-name", "synthetic", *TINY, "name=yolo", "mode=inference",
                 "run.distributed=true", f"output_dir={out_dir}", "run.id=yolo",
                 "data.synthetic_events=8"])
    soft = validate(cfg("soft", "mode=inference",
                        f"mode.output_file={out_dir}/softmax_dp.npz"))
    tasks = {task: main(["--config-name", "synthetic", *TINY, f"name={task}",
                         "mode=train", "mode.iterations=2", "run.distributed=true",
                         "data.transform1=true", "data.transform2=true",
                         f"output_dir={out_dir}", f"run.id=task_{task}",
                         "data.synthetic_events=8"])
             for task in TASKS}
    return dict(
        shards=shards, writes=writes,
        first=(first.first_step, len(first.history)),
        resumed=(resumed.first_step, len(resumed.history), digest(resumed.state.model)),
        odd_steps=len(odd.history), yolo=yolo, softmax_metrics=soft, tasks=tasks,
    )


FAMILIES = {
    "dense": ["framework.mode=dense"],
    "pointnet": ["encoder=pointnet", "encoder.max_points=64"],
    "dgcnn": ["encoder=dgcnn", "encoder.max_points=64", "encoder.k=4",
              "encoder.emb_dims=64"],
}


def families_job(rank, world, out_dir):
    """Two supervised steps and inference of the dense and point-cloud
    families with run.distributed=true: the metrics of every step and of
    validation, and the final parameters and buffers."""
    from sparseeventid_tpu_torch.config import load_config
    from sparseeventid_tpu_torch.train import trainer
    from sparseeventid_tpu_torch.train.evaluate import validate

    out = {}
    for family, extra in FAMILIES.items():
        common = TINY + ["run.distributed=true", f"output_dir={out_dir}",
                         f"run.id={family}", "data.synthetic_events=8", *extra]
        run = trainer.train(load_config("synthetic", common + [
            "mode=train", "mode.iterations=2"]))
        val = validate(load_config("synthetic", common + ["mode=inference"]))
        model = run.state.model
        out[family] = dict(
            history=run.history, validation=val,
            params=[p.detach().clone() for p in model.parameters()],
            buffers=[b.clone() for b in model.buffers()])
    return out


def pair_job(rank, world, state_path):
    """(a)-(d) in one group of two."""
    return {**stats_and_nt_xent_job(rank, world),
            **dp_step_job(rank, world, state_path)}
