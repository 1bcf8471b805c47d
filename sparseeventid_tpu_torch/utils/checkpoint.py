"""Checkpoints (JAX counterpart: ``utils/checkpoint.py``) — parity with the
reference's two checkpoint systems (reference src/utils/
create_trainer.py:83-118 ModelCheckpoint + auto-resume;
src/utils/torch/trainer.py:454-583 text index + keep-5 GC), including
encoder-only transfer + freeze (create_trainer.py:94-106).

Format: one ``torch.save`` file a step, ``step_<n>.pt``, holding the model's
``state_dict`` (parameters and running statistics), the optimizer's and the
schedule's state and the step; a human-readable ``checkpoint`` index file
with a ``latest:`` line; keep-N garbage collection.  Under data parallelism
rank 0 alone writes, and every rank waits for the file before it goes on.
Files are loaded with ``weights_only=True``.  The JAX package's msgpack
checkpoints are not read here: ``convert.params_from_jax`` carries JAX
weights across.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Set

import torch

from ..parallel import mesh
from ..train.state import TrainState

logger = logging.getLogger(__name__)

SUFFIX = ".pt"


def load_checkpoint(path: str | Path, device: torch.device | str) -> Dict:
    """The contents of one checkpoint file, its tensors on ``device``."""
    return torch.load(Path(path), map_location=device, weights_only=True)


def restore_into(payload: Dict, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer | None = None,
                 scheduler=None) -> int:
    """Load a checkpoint's model (and, where given, optimizer and schedule)
    state -> its step."""
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"])


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 5):
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        self.index = self.dir / "checkpoint"

    def path(self, step: int) -> Path:
        return self.dir / f"step_{step}{SUFFIX}"

    # ---- save -----------------------------------------------------------
    def save(self, state: TrainState) -> Path:
        path = self.path(state.step)
        if mesh.is_main():
            self._write(state, path)
        mesh.barrier()  # no rank reads or resumes before the file is whole
        return path

    def _write(self, state: TrainState, path: Path) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
        }
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        self._update_index(state.step)
        self._gc()
        logger.info("Saved checkpoint %s", path)

    def _write_index(self, steps: List[int]):
        lines = [f"latest: step_{steps[-1]}{SUFFIX}"] + [
            f"step: step_{e}{SUFFIX}" for e in steps
        ]
        self.index.write_text("\n".join(lines) + "\n")

    def _update_index(self, step: int):
        entries = [e for e in self._read_index() if e != step] + [step]
        self._write_index(entries)

    def _read_index(self) -> List[int]:
        if not self.index.exists():
            return []
        steps = []
        for line in self.index.read_text().splitlines():
            if line.startswith("step: step_"):
                steps.append(int(line.split("step_")[1].split(".")[0]))
        return steps

    def _gc(self):
        entries = self._read_index()
        if len(entries) <= self.keep:
            return
        for old in entries[: -self.keep]:
            self.path(old).unlink(missing_ok=True)
        self._write_index(entries[-self.keep:])

    # ---- restore --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        entries = self._read_index()
        if entries:
            return entries[-1]
        # no index: the newest file (create_trainer.py:111-118 auto-resume)
        steps = [int(p.name[len("step_"):-len(SUFFIX)])
                 for p in self.dir.glob(f"step_*{SUFFIX}")]
        return max(steps) if steps else None

    def restore(self, state: TrainState, device: torch.device | str,
                step: Optional[int] = None) -> int:
        """Load step ``step`` (default the newest) into ``state`` -> step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.path(step)
        state.step = restore_into(load_checkpoint(path, device), state.model,
                                  state.optimizer, state.scheduler)
        logger.info("Restored checkpoint %s", path)
        return state.step


def encoder_freeze_names(model: torch.nn.Module) -> Set[str]:
    """The parameters a transfer run freezes: ``encoder.*`` (the PyTorch
    form of the JAX ``encoder_freeze_mask``)."""
    return {n for n, _ in model.named_parameters() if n.startswith("encoder.")}


def load_encoder_only(model: torch.nn.Module, path: str | Path,
                      device: torch.device | str) -> Set[str]:
    """Transfer-learning restore: copy the encoder's parameters, and only
    its parameters, from a checkpoint (create_trainer.py:94-106
    restore_encoder_only).  As in the JAX package, which copies
    ``params["encoder"]`` and leaves ``batch_stats`` alone, the encoder's
    batch-norm running statistics are not copied.  -> the names copied."""
    source = load_checkpoint(path, device)["model"]
    names = encoder_freeze_names(model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in names:
            params[name].copy_(source[name])
    return names


def transfers_encoder(mode) -> bool:
    """Whether a run's mode asks for an encoder-only transfer."""
    return bool(mode.weights_location
                and getattr(mode, "restore_encoder_only", False))


def restore_run(mode, ckpt: CheckpointManager, model: torch.nn.Module,
                device: torch.device | str,
                optimizer: torch.optim.Optimizer | None = None,
                scheduler=None) -> Optional[int]:
    """A run's restore, in the JAX ``Trainer._restore`` order: (a) with
    ``mode.weights_location`` and ``mode.restore_encoder_only``, the
    encoder's parameters from that file; (b) with ``weights_location``
    alone, the whole checkpoint in that file; (c) else the newest checkpoint
    of ``ckpt``, if any.  -> the step restored (None for (a) and when there
    is nothing to restore)."""
    location = mode.weights_location
    if transfers_encoder(mode):
        load_encoder_only(model, location, device)
        logger.info("Transferred encoder weights from %s (encoder frozen)",
                    location)
        return None
    if location:
        step = restore_into(load_checkpoint(location, device), model,
                            optimizer, scheduler)
        logger.info("Restored full state from %s (step %d)", location, step)
        return step
    step = ckpt.latest_step()
    if step is None:
        return None
    restore_into(load_checkpoint(ckpt.path(step), device), model, optimizer,
                 scheduler)
    logger.info("Auto-resumed from step %d", step)
    return step
