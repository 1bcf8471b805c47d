"""Inference mode: run the validation split once, report the mean loss and
per-head accuracy, and write the per-event softmax to ``mode.output_file``
when it is set: larcv style (``Data/softmax_<head>_group/scores``) for a
``.h5`` name, else ``.npz`` (JAX counterpart: ``Trainer.validate``,
supervised task only).  The weights are restored as a train run restores
them (``utils.checkpoint.restore_run``): an encoder-only transfer or a full
restore from ``mode.weights_location``, else the newest checkpoint of the
run directory.

A split's data is its larcv file (``data.train`` / ``data.val`` /
``data.test``), or, for the word ``synthetic`` or an empty name under the
synthetic detector, synthetic events on the detector's grid.  The
supervised task runs every model family (``models.build.build_model``:
sparse, dense or point-cloud input).  Each batch's window plans of a sparse
model are built on the host (``train/plans.py``) unless
``SEID_HOST_PLANS=0``.

Entry points run on the card.  They use the CPU only when asked, by
``device="cpu"`` or ``run.compute_mode=CPU``; otherwise a machine without a
CUDA device raises.

With ``run.distributed`` (``parallel/mesh.py``) rank r validates its
contiguous shard of the split, every rank as many batches; the metrics are
averaged across ranks and the dropped counts summed.  The softmax file is
gathered to rank 0 in event order and written once, so a split that the
ranks' batches cover gives the one-process file; yolo writes one
``val_rank_<rank>.npz`` a rank.
"""

from __future__ import annotations

import logging
import zlib
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from ..config.schema import (
    OUTPUT_SHAPE,
    ComputeMode,
    Detector,
    LossBalanceScheme,
    OptimizerConfig,
    Precision,
    SparseEventIDConfig,
    image_size,
)
from ..io import (
    SyntheticDataset,
    SyntheticEventConfig,
    larcv_batch_to_dense,
    larcv_batch_to_pointcloud,
    larcv_batch_to_sparse_2d,
    larcv_batch_to_sparse_3d,
)
from ..models import DENSE, POINTS, SPARSE, build_model, init_parameters
from ..parallel import mesh
from ..utils.checkpoint import CheckpointManager, restore_run
from ..utils.logger import process_log
from .plans import run_planner
from .supervised import eval_metrics

logger = logging.getLogger(__name__)

SYNTHETIC = "synthetic"  # a split name that asks for synthetic events


def resolve_device(cfg: SparseEventIDConfig | None = None,
                   device: torch.device | str | None = None) -> torch.device:
    """The explicit ``device`` if given; under run.distributed this rank's
    device, after joining the process group (``mesh.initialize_distributed``);
    the CPU for run.compute_mode=CPU, else the card.  Raises when the card
    is wanted and none is present."""
    if device is not None:
        dev = torch.device(device)
    elif cfg is not None and cfg.run.distributed:
        dev = mesh.initialize_distributed(cfg)
    elif cfg is not None and cfg.run.compute_mode == ComputeMode.CPU:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' or run.compute_mode=CPU to "
            "run on the host"
        )
    return dev


def feature_dtype(cfg: SparseEventIDConfig) -> torch.dtype:
    """bf16 features for bfloat16/mixed/float16 precision, else float32."""
    low = (Precision.bfloat16, Precision.mixed, Precision.float16)
    return torch.bfloat16 if cfg.run.precision in low else torch.float32


def run_dir(cfg: SparseEventIDConfig) -> Path:
    """``<output_dir>/<detector>/<run.id>``: process.log, tb/, checkpoints/."""
    return Path(cfg.output_dir) / cfg.data.detector.name / str(cfg.run.id)


def build_dataset(cfg: SparseEventIDConfig, split: str = "val"):
    """The dataset of a split: its larcv file, read on the detector's grid
    unless the file carries its own; or synthetic events seeded as the JAX
    trainer seeds them (2D multiplane: 3D tracks on (H, H, W), projected
    per plane).  A real detector with no file named raises."""
    path = getattr(cfg.data, split)
    shape = image_size(cfg)
    if path and path != SYNTHETIC:
        from ..io.larcv import LarcvDataset

        return LarcvDataset(
            path, image_key=cfg.data.image_key, dimension=cfg.data.dimension,
            max_voxels=cfg.data.max_voxels, normalize=cfg.data.normalize,
            image_size=shape if cfg.data.dimension == 3 else shape[1:],
        )
    if not path and cfg.data.detector != Detector.synthetic:
        raise ValueError(
            f"data.{split}: no larcv file given for detector "
            f"{cfg.data.detector.name}; name one, or '{SYNTHETIC}' for "
            "synthetic events on its grid"
        )
    if cfg.data.dimension == 2:
        gen_size, planes = (shape[1],) + tuple(shape[1:]), shape[0]
    else:
        gen_size, planes = shape, 1
    return SyntheticDataset(
        cfg.data.synthetic_events,
        SyntheticEventConfig(
            image_size=gen_size,
            n_planes=planes,
            max_voxels=cfg.data.max_voxels,
            normalize=cfg.data.normalize,
        ),
        seed=(zlib.crc32(split.encode()) + cfg.run.seed) % 2**31,
    )


def close_datasets(datasets) -> None:
    """Close what the datasets hold open (a larcv reader's file)."""
    for ds in datasets:
        if hasattr(ds, "close"):
            ds.close()


def max_points(cfg: SparseEventIDConfig) -> int:
    """The point clouds' capacity (``encoder.max_points``)."""
    return getattr(cfg.encoder, "max_points", 2048)


def to_input(image: np.ndarray, grid, capacity: int | None,
             dtype: torch.dtype, device: torch.device, mode: str = SPARSE,
             points: int = 2048):
    """A padded larcv image array -> the input of a model family on the
    device, in the feature type (the JAX trainer's ``_image_to_input``):
    ``sparse``, a SparseTensor of ``capacity`` rows (a 4-D image is 2D
    multiplane data, [B, planes, MaxVoxels, 3]); ``dense``, the grid
    [B, *grid, 1]; ``points``, (points [B, points, D+1], mask).  The dense
    and point-cloud conversions take 3-D images only."""
    if mode == DENSE:
        dense = torch.from_numpy(larcv_batch_to_dense(image, tuple(grid)))
        return dense.to(device).to(dtype)
    if mode == POINTS:
        pts, mask = larcv_batch_to_pointcloud(image, points)
        return (torch.from_numpy(pts).to(device).to(dtype),
                torch.from_numpy(mask).to(device))
    to_sparse = (larcv_batch_to_sparse_2d if image.ndim == 4
                 else larcv_batch_to_sparse_3d)
    st = to_sparse(image, grid, capacity=capacity, device=device)
    return st.with_feats(st.feats.to(dtype))


def prepare_batch(batch, grid, capacity: int | None, dtype: torch.dtype,
                  device: torch.device, mode: str = SPARSE,
                  points: int = 2048):
    """A dataset batch (padded numpy arrays) -> (the model's input on the
    device in the feature type, see ``to_input``; labels on the device)."""
    x = to_input(batch["image"], grid, capacity, dtype, device, mode, points)
    labels = {k: torch.from_numpy(batch[k]).to(device) for k in OUTPUT_SHAPE}
    return x, labels


def input_capacity(model: torch.nn.Module, mode: str) -> int | None:
    """The level-0 capacity of a sparse model's input (None otherwise)."""
    return model.encoder.capacities[0] if mode == SPARSE else None


def class_weights_of(scheme, device):
    if scheme != LossBalanceScheme.even:
        return None
    return {
        k: torch.tensor([0.582, 1.417], device=device)
        for k, n in OUTPUT_SHAPE.items() if n == 2
    }


def write_softmax(path: str | Path, outputs: Dict[str, np.ndarray]) -> None:
    """Per-event softmax by head: larcv style for ``.h5`` (the JAX layout,
    ``Data/softmax_<head>_group/scores``; the legacy ana_step,
    torch_inference.py:719-776), else one ``.npz``."""
    if str(path).endswith(".h5"):
        import h5py

        with h5py.File(path, "w") as f:
            g = f.require_group("Data")
            for k, arr in outputs.items():
                g.create_group(f"softmax_{k}_group").create_dataset(
                    "scores", data=arr)
    else:
        np.savez(path, **outputs)


def shard_batches(n_events: int, batch_size: int):
    """This rank's batches of event indices: its contiguous shard of the
    split in batches of ``batch_size``, as many batches on every rank (one
    process: every event, the last batch short if it must be)."""
    shard = np.array_split(np.arange(n_events), mesh.world())[mesh.rank()]
    n_batches = mesh.min_across(max(len(shard) // batch_size, 1))
    return [shard[i * batch_size:(i + 1) * batch_size].tolist()
            for i in range(n_batches)]


def validate(
    cfg: SparseEventIDConfig,
    dataset=None,
    params: Mapping[str, torch.Tensor] | None = None,
    device: torch.device | str | None = None,
) -> Dict[str, float]:
    """Run the validation split once -> mean metrics (``overflow/dropped``
    is the total over the run).  The supervised task can write its softmax
    (``mode.output_file``); yolo writes its per-event outputs to
    ``<run dir>/validation_output/val_rank_<rank>.npz``.

    ``dataset`` (``__len__``, ``batch(indices)``, ``batch_grid()``) defaults
    to the config's val split (test without one); ``params`` is a
    ``state_dict`` to evaluate (e.g. from ``convert.params_from_jax``),
    default a seeded random initialisation and then the run's restore."""
    from .tasks import task_check

    task_check(cfg)
    dev = resolve_device(cfg, device)
    out_dir = run_dir(cfg)
    with process_log(out_dir / "process.log"):
        owned = []
        if dataset is None:
            dataset = build_dataset(
                cfg, "val" if "val" in cfg.data.active else "test")
            owned.append(dataset)
        try:
            if cfg.name == "supervised_eventID":
                return _validate(cfg, dataset, params, dev, out_dir)
            return _validate_task(cfg, dataset, params, dev, out_dir)
        finally:
            close_datasets(owned)


def _validate(cfg, dataset, params, dev, out_dir) -> Dict[str, float]:
    model, mode = build_model(cfg)
    if params is None:
        init_parameters(model, cfg.run.seed)
        model.to(dev)
        restore_run(cfg.mode, CheckpointManager(out_dir / "checkpoints"),
                    model, dev)
    else:
        model.load_state_dict(params)
        model.to(dev)
    model.eval()
    dtype = feature_dtype(cfg)
    grid = dataset.batch_grid()
    cap0 = input_capacity(model, mode)
    opt_cfg = getattr(cfg.mode, "optimizer", None) or OptimizerConfig()
    scheme = opt_cfg.loss_balance_scheme
    class_weights = class_weights_of(scheme, dev)
    output_file = getattr(cfg.mode, "output_file", "")
    planner = run_planner(cfg, grid)

    batches = shard_batches(len(dataset), cfg.run.minibatch_size)
    per_batch = []
    outputs = {k: [] for k in OUTPUT_SHAPE}
    for indices in batches:
        batch = dataset.batch(indices)
        x, labels = prepare_batch(batch, grid, cap0, dtype, dev, mode,
                                  max_points(cfg))
        with torch.no_grad():
            plans = None
            if planner is not None:
                plans = planner.plans(
                    x, planner.to_device(planner.build(batch["image"]), dev))
            logits, dropped = model(x, plans=plans)
            m = mesh.reduce_metrics(
                eval_metrics(logits, labels, dropped, scheme, class_weights))
        per_batch.append({k: float(v) for k, v in m.items()})
        if output_file:
            for k in OUTPUT_SHAPE:
                outputs[k].append(torch.softmax(logits[k], dim=-1))
    mean = {
        k: float(np.mean([m[k] for m in per_batch])) for k in per_batch[0]
    }
    mean["overflow/dropped"] = float(sum(m["overflow/dropped"] for m in per_batch))
    logger.info("validation over %d batches a rank: %s", len(batches), mean)
    if output_file:
        with torch.no_grad():  # every rank's rows, in rank (= event) order
            scores = {k: mesh.all_gather_rows(torch.cat(v)).cpu().numpy()
                      for k, v in outputs.items()}
        if mesh.is_main():
            write_softmax(output_file, scores)
            logger.info("wrote softmax outputs to %s", output_file)
    return mean


def _validate_task(cfg, dataset, params, dev, out_dir) -> Dict[str, float]:
    """validate() for simclr, yolo and unsupervised_eventID: the task's
    eval step over the split (JAX ``Trainer.validate``), and for yolo the
    predict step's outputs, one ``.npz`` (keys label, vertex_true, anchor,
    vertex, pred_label; the reference's vertex_finding.py:154-178)."""
    from .tasks import LOADER_PLANS, build_task

    grid = tuple(dataset.batch_grid())
    planner = run_planner(cfg, grid) if cfg.name in LOADER_PLANS else None
    task = build_task(cfg, dataset, grid, 1, params, dev, planner)
    if params is None:
        restore_run(cfg.mode, CheckpointManager(out_dir / "checkpoints"),
                    task.state.model, dev)
    batches = shard_batches(len(dataset), cfg.run.minibatch_size)
    per_batch, outputs = [], []
    for indices in batches:
        args = task.prepare(dataset.batch(indices))
        per_batch.append({k: float(v) for k, v in task.eval_step(args).items()})
        if task.predict is not None:
            outputs.append({k: v.cpu().numpy()
                            for k, v in task.predict(args).items()})
    mean = {k: float(np.mean([m[k] for m in per_batch])) for k in per_batch[0]}
    mean["overflow/dropped"] = float(sum(m["overflow/dropped"] for m in per_batch))
    logger.info("validation over %d batches a rank: %s", len(batches), mean)
    if outputs:
        path = out_dir / "validation_output" / f"val_rank_{mesh.rank()}.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{k: np.concatenate([o[k] for o in outputs])
                          for k in outputs[0]})
        logger.info("wrote vertex validation outputs to %s", path)
    return mean
