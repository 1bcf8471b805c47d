"""Data parallelism over ``torch.distributed`` (JAX counterpart:
``parallel/mesh.py``).

One process a device, as in the reference's DDP and the JAX package's
multi-host layout.  Each rank reads its own contiguous shard of a split
(``io.dataset.BatchLoader(process_index, process_count)``) and takes
``run.minibatch_size`` events a step, so the global batch is world x
minibatch.  What ``axis_name`` carries through a JAX step is here a
collective on the default process group:

  all_reduce_sum   sync batch norm's packed (count, sum, sum of squares)
                   (``ops/norm.masked_batch_stats``); differentiable
  all_gather_rows  NT-Xent's projections of every rank, in rank order
                   (``train/losses.nt_xent_loss``); differentiable
  mean_gradients   the gradient mean before an optimizer step
                   (``train/state.TrainState.apply_gradients``), in place
  reduce_metrics   a step's metrics: the mean across ranks, with
                   ``overflow/dropped`` summed

Without a process group each is the identity, so a one-process run is
unchanged; a group of one gives the same bits as none.

``make_mesh``, ``shard_batch`` and ``make_dp_train_step`` have no
counterpart here.  They place one program's arrays on the devices of a mesh
and wrap the step in ``shard_map``.  With one process a device there is no
mesh to place a batch on: each rank's loader makes its own shard, and the
ordinary step runs on every rank, its collectives doing what the named axis
did under ``shard_map``.

``framework.distributed_mode`` DDP, horovod and shard_map all take this one
path, as all three take ``shard_map`` in the JAX package.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Iterable

import torch
import torch.distributed as dist

from ..config.schema import ComputeMode, SparseEventIDConfig

logger = logging.getLogger(__name__)

# torchrun's environment: any of these set means a configured bootstrap
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# a lost rank fails the run after this long instead of hanging it
TIMEOUT = datetime.timedelta(minutes=10)
SUMMED = ("overflow/dropped",)  # metrics summed across ranks, not averaged


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def rank_device(cfg: SparseEventIDConfig) -> torch.device:
    """This rank's device: the CPU for run.compute_mode=CPU, else
    ``cuda:(LOCAL_RANK // framework.oversubscribe)``; raises when that card
    does not exist."""
    if cfg.run.compute_mode == ComputeMode.CPU:
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    index = local // max(int(cfg.framework.oversubscribe), 1)
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"local rank {local} with framework.oversubscribe="
            f"{cfg.framework.oversubscribe} wants cuda:{index}, but this "
            f"machine has {count} CUDA device(s)")
    return torch.device("cuda", index)


def backend_for(cfg: SparseEventIDConfig, device: torch.device) -> str:
    """NCCL on the card with one rank a card; gloo on the CPU and for
    ranks that share a card (NCCL refuses two ranks on one device; the
    reference's create_trainer.py:52-58)."""
    if device.type == "cuda" and int(cfg.framework.oversubscribe) <= 1:
        return "nccl"
    return "gloo"


def initialize_distributed(cfg: SparseEventIDConfig,
                           timeout: datetime.timedelta = TIMEOUT
                           ) -> torch.device:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) ->
    this rank's device.

    With none of them set the run goes on as one process with no group and
    a warning (as JAX's ``initialize_distributed``).  When they are set, a
    bootstrap that fails raises: a configured run never degrades to one
    process.  A group already joined is kept."""
    if is_initialized():
        return rank_device(cfg)
    if not any(v in os.environ for v in ENV):
        logger.warning("run.distributed: none of %s is set; continuing as "
                       "one process", ", ".join(ENV))
        return rank_device(cfg)
    device = rank_device(cfg)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(cfg, device)
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    logger.info("rank %d of %d on %s (%s, framework.distributed_mode=%s)",
                rank(), world(), device, backend,
                cfg.framework.distributed_mode.name)
    return device


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; its transpose is the same sum of the gradients
    (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


class _AllGatherRows(torch.autograd.Function):
    """[n, ...] on each rank -> [world * n, ...] in rank order.  Backward
    sums the gathered gradient across ranks and keeps this rank's block:
    the transpose of JAX's ``all_gather`` (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x)
        ctx.rows = (rank() * x.shape[0], (rank() + 1) * x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        lo, hi = ctx.rows
        return grad[lo:hi]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank, differentiable; ``x`` itself
    without a group."""
    return _AllReduceSum.apply(x) if is_initialized() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on the first axis in rank order (each rank
    holds as many rows), differentiable; ``x`` itself without a group."""
    return _AllGatherRows.apply(x) if is_initialized() else x


@torch.no_grad()
def mean_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean across ranks (JAX ``pmean``).
    The gradients are packed in parameter order into one flat buffer and
    all-reduced at once, so the summation order is fixed at a given world
    size."""
    if not is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world())
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, object]) -> Dict[str, object]:
    """A step's metrics across ranks: each tensor the mean over ranks
    (``overflow/dropped`` the sum), in one float64 all-reduce; other values
    (``opt/lr``) as they are.  The result lies on the collective's device
    (the card under NCCL, the host under gloo)."""
    if not is_initialized():
        return metrics
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return metrics
    device = _collective_device()
    packed = torch.stack([metrics[k].detach().reshape(()).to(device).double()
                          for k in keys])
    dist.all_reduce(packed)
    out = dict(metrics)
    for i, k in enumerate(keys):
        v = packed[i] if k in SUMMED else packed[i] / world()
        out[k] = v.to(metrics[k].dtype)
    return out


def min_across(value: int) -> int:
    """The least of ``value`` over the ranks (``value`` without a group)."""
    if not is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank."""
    if not is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def destroy() -> None:
    """Leave the default process group, if one was joined."""
    if is_initialized():
        dist.destroy_process_group()
