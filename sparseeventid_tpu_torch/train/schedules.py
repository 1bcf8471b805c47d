"""Per-step learning-rate schedules as step -> lr functions of plain Python
numbers, the form ``torch.optim.lr_scheduler.LambdaLR`` takes (JAX
counterpart: ``train/schedules.py``).

warmup_flat_decay: linear warm-up from 1e-5 over one epoch to the peak, flat
for (total - decay - 1) epochs, then exponential decay (rate 0.01 per step)
to a floor.  one_cycle: a triangle up over half the non-decay steps and down
to min_lr, then the same decay.  Past its end a schedule gives 0.

The arithmetic is float32, operation for operation as the JAX package's, so
that both packages train with the same rates (in float64 the end of a ramp
differs by a few 1e-6 of the rate).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..config.schema import LRScheduleConfig, OneCycleConfig, WarmupFlatDecayConfig

Schedule = Callable[[int], float]


_f32 = np.float32


def _linear(step, start, stop, length):
    return _f32(start) + step * _f32(stop - start) / _f32(max(length, 1))


def _decay(step, start, floor, rate=0.01):
    return _f32(start - floor) * np.exp(_f32(-rate) * step) + _f32(floor)


def warmup_flat_decay(
    peak_lr: float,
    decay_floor: float,
    epoch_length: int,
    decay_epochs: int,
    total_epochs: int,
) -> Schedule:
    warm = epoch_length
    flat_len = max(total_epochs - decay_epochs - 1, 0) * epoch_length
    decay_len = decay_epochs * epoch_length

    def schedule(step):
        step = _f32(step)
        if step < warm:
            return float(_linear(step, 1e-5, peak_lr, warm))
        if step < warm + flat_len:
            return float(_f32(peak_lr))
        if step < warm + flat_len + decay_len:
            return float(_decay(step - _f32(warm) - _f32(flat_len), peak_lr,
                                decay_floor))
        return 0.0

    return schedule


def one_cycle(
    min_lr: float,
    peak_lr: float,
    decay_floor: float,
    epoch_length: int,
    decay_epochs: int,
    total_epochs: int,
) -> Schedule:
    total_steps = epoch_length * total_epochs
    decay_len = int(epoch_length * decay_epochs)
    up = int(0.5 * (total_epochs - decay_epochs) * epoch_length)
    down = total_steps - up - decay_len

    def schedule(step):
        step = _f32(step)
        if step < up:
            return float(_linear(step, min_lr, peak_lr, up))
        if step < up + down:
            return float(_linear(step - _f32(up), peak_lr, min_lr, down))
        if step < up + down + decay_len:
            return float(_decay(step - _f32(up) - _f32(down), min_lr,
                                decay_floor))
        return 0.0

    return schedule


def flat(peak_lr: float) -> Schedule:
    return lambda step: float(_f32(peak_lr))


def build_lr_schedule(
    cfg: LRScheduleConfig, epoch_length: int, total_epochs: int
) -> Schedule:
    """Select by config."""
    if isinstance(cfg, OneCycleConfig) or cfg.name == "one_cycle":
        return one_cycle(
            getattr(cfg, "min_learning_rate", 1e-5),
            cfg.peak_learning_rate,
            getattr(cfg, "decay_floor", 1e-5),
            epoch_length,
            getattr(cfg, "decay_epochs", 5),
            total_epochs,
        )
    if isinstance(cfg, WarmupFlatDecayConfig) or cfg.name == "standard":
        return warmup_flat_decay(
            cfg.peak_learning_rate,
            getattr(cfg, "decay_floor", 1e-3),
            epoch_length,
            getattr(cfg, "decay_epochs", 5),
            total_epochs,
        )
    return flat(cfg.peak_learning_rate)
