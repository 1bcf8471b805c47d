"""Host-built window plans on the train and inference paths (JAX
counterpart: the plan methods of ``train/trainer.py``'s ``Trainer``,
``_plans_enabled``, ``_plan_kernels``, ``_plan_geometry``,
``_compute_host_plans``, ``_host_plans`` and ``_plans_builder``).

The main path builds every plan of a batch on the host: the loader's
thread runs ``io.hostio.build_window_plans`` (C++ workers, one an event)
while the card runs the previous step, a per-event ``PlanCache`` keeps the
plans of the train split from epoch to epoch, and the step copies the dict
to the card and assembles the encoder's plans there
(``ops.host_plans.encoder_plans_from_host``).  ``SEID_HOST_PLANS=0`` is the
one road to the device plan builders.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config.schema import SparseEventIDConfig
from ..io.hostio import build_window_plans
from ..io.plan_cache import PlanCache
from ..models.build import SPARSE, build_sparse_classifier, model_family
from ..ops.engine import WINDOW, host_list_width
from ..ops.host_plans import EncoderPlans, encoder_plans_from_host
from ..ops.sparse_tensor import SparseTensor
from ..utils import telemetry

logger = logging.getLogger(__name__)

HOST_PLANS_ENV = "SEID_HOST_PLANS"


def plans_enabled(cfg: SparseEventIDConfig) -> bool:
    """Whether the run builds its window plans on the host: the window
    backend's sparse encoder, 2D or 3D, unless SEID_HOST_PLANS=0 (the
    dense and point-cloud families have no plans)."""
    return (
        os.environ.get(HOST_PLANS_ENV, "1") != "0"
        and cfg.framework.sparse_backend == WINDOW
        and model_family(cfg) == SPARSE
        and cfg.data.dimension in (2, 3)
    )


def plan_geometry(encoder, grid: Sequence[int]) -> Dict:
    """``build_window_plans``'s arguments for ``encoder`` on ``grid``: the
    encoder's own kernels, stride, capacities and window rows, so plan and
    kernel cannot disagree; the host list widths."""
    ik, sks, stride = encoder.plan_kernels()
    caps = [int(c) for c in encoder.capacities]
    if None in encoder.capacities:
        raise ValueError("host plans need the encoder's static capacities")
    tuning = encoder.tuning
    return dict(
        grid=tuple(int(g) for g in grid),
        caps=caps,
        initial_kernel=ik,
        series_kernel=sks,
        stride=stride,
        window_r=tuning.window_r,
        ov_caps=[host_list_width(c, int(np.prod(k))) for c, k in zip(caps, sks)],
        ov_cap_initial=host_list_width(caps[0], int(np.prod(ik))),
        ov_caps_down=[host_list_width(c, int(np.prod(stride))) for c in caps[:-1]],
        window_r_down=tuning.window_r_strided,
        window_r_initial=tuning.window_r_initial,
        window_r_series=[tuning.for_level(l) for l in range(len(caps))],
    )


def plan_coords(image: np.ndarray, grid: Sequence[int]) -> np.ndarray:
    """A padded larcv batch -> i32[B, N, 3] level-0 coordinates, -1 where a
    row is not a site: the mapping of ``io.transforms``'
    ``larcv_batch_to_sparse_3d`` / ``_2d`` (a 4-D image is 2D multiplane
    data; its planes flatten to (plane, y, x) on the plane-axis grid)."""
    if image.ndim == 4:
        b, planes, n, _ = image.shape
        xy = image[..., :2]
        valid = np.all(xy != -999.0, axis=-1) & (image[..., 2] != -999.0)
        yx = xy[..., ::-1]
        h, w = int(grid[1]), int(grid[2])
        valid &= ((yx[..., 0] >= 0) & (yx[..., 0] < h)
                  & (yx[..., 1] >= 0) & (yx[..., 1] < w))
        plane = np.broadcast_to(
            np.arange(planes, dtype=np.int32)[None, :, None], (b, planes, n))
        coords = np.concatenate([plane[..., None], yx.astype(np.int32)], -1)
        coords = np.where(valid[..., None], coords, -1)
        return np.ascontiguousarray(coords.reshape(b, planes * n, 3), np.int32)
    coords = image[..., :-1]
    valid = np.all(coords != -999.0, axis=-1) & (image[..., -1] != -999.0)
    return np.ascontiguousarray(
        np.where(valid[..., None], coords, -1).astype(np.int32))


WIDTH_KEYS = ("ov_caps", "ov_cap_initial", "ov_caps_down")
LIST_QUANTUM = 256  # a widened list is a multiple of this


def grown_widths(host: Dict[str, np.ndarray], geometry: Dict) -> Optional[Dict]:
    """The geometry with each list that dropped pairs in ``host`` widened to
    hold all of them (rounded up to LIST_QUANTUM), or None if none dropped.
    A plan's pairs are its valid entries plus its ``ov_dropped``."""

    def need(prefix):
        return int((host[f"{prefix}/ov_valid"].sum(axis=1)
                    + host[f"{prefix}/ov_dropped"]).max(initial=0))

    def fit(width, n):
        return max(width, -(-n // LIST_QUANTUM) * LIST_QUANTUM)

    depth = len(geometry["caps"]) - 1
    grown = dict(geometry)
    grown["ov_cap_initial"] = fit(geometry["ov_cap_initial"], need("initial"))
    grown["ov_caps"] = [fit(w, need(f"lvl{l}/series"))
                        for l, w in enumerate(geometry["ov_caps"])]
    grown["ov_caps_down"] = [
        fit(w, max(need(f"lvl{l}/down_f"), need(f"lvl{l}/down_r")))
        for l, w in zip(range(depth), geometry["ov_caps_down"])]
    if all(grown[k] == geometry[k] for k in WIDTH_KEYS):
        return None
    return grown


class HostPlanner:
    """Builds the host plans of one model on one grid, with a per-event
    cache of ``cache_mb`` MB for batches that carry their dataset indices
    (0: no cache), and turns a copied dict into the encoder's plans.

    The lists have the JAX package's widths (``ops.engine.host_list_width``)
    unless a batch has more pairs: then it is built again with those lists
    widened to hold them (``grown_widths``), so no pair is ever dropped;
    ``widened`` counts those builds."""

    def __init__(self, encoder, grid: Sequence[int], cache_mb: int = 0):
        self.geometry = plan_geometry(encoder, grid)
        self.tuning = encoder.tuning
        self.q_bound_fracs = encoder.q_bound_fracs
        self.widened = 0
        self.cache: Optional[PlanCache] = None
        if cache_mb > 0:
            self.cache = PlanCache(self.build_coords,
                                   max_bytes=int(cache_mb) << 20)

    def build_coords(self, coords: np.ndarray) -> Dict[str, np.ndarray]:
        """The plan dict of level-0 coordinates i32[B, N, 3] (-1: no site)."""
        host = build_window_plans(coords, **self.geometry)
        grown = grown_widths(host, self.geometry)
        if grown is None:
            return host
        self.widened += 1
        logger.info("host plan lists widened to hold every pair: %s",
                    {k: grown[k] for k in WIDTH_KEYS})
        with telemetry.span("plans.rebuild"):
            return build_window_plans(coords, **grown)

    def build(self, image: np.ndarray, indices=None,
              split: str = "") -> Dict[str, np.ndarray]:
        """The plan dict of a padded larcv batch, through the cache when
        ``indices`` are given."""
        with telemetry.span("plans.build"):
            coords = plan_coords(image, self.geometry["grid"])
            if indices is not None and self.cache is not None:
                return self.cache.plans_for(split, coords, indices)
            return self.build_coords(coords)

    def transform(self, split: str):
        """A ``BatchLoader`` transform that adds the batch's plans as
        ``host_plans``, built in the loader's thread."""

        def add_plans(batch: Dict) -> Dict:
            return {**batch, "host_plans": self.build(
                batch["image"], batch.get("index"), split)}

        return add_plans

    def for_batch(self, batch: Dict) -> Dict[str, np.ndarray]:
        """The batch's plans: those its loader built, else built now."""
        if "host_plans" in batch:
            return batch["host_plans"]
        return self.build(batch["image"])

    @staticmethod
    def to_device(host: Dict[str, np.ndarray],
                  device: torch.device) -> Dict[str, torch.Tensor]:
        with telemetry.span("prepare.plans_copy"):
            return {k: torch.from_numpy(v).to(device, non_blocking=True)
                    for k, v in host.items()}

    def plans(self, st: SparseTensor, host: Dict[str, torch.Tensor]
              ) -> EncoderPlans:
        """The encoder's plans for ``st`` from a dict on its device."""
        g = self.geometry
        return encoder_plans_from_host(
            st, host, g["initial_kernel"], g["series_kernel"], g["stride"],
            self.tuning, self.q_bound_fracs)


def planner_for(cfg: SparseEventIDConfig, encoder, grid: Sequence[int],
                cache: bool = False) -> Optional[HostPlanner]:
    """The run's planner, or None when its plans are built on the device.
    ``cache``: keep the plans of indexed batches (the train loop's)."""
    if not plans_enabled(cfg):
        return None
    return HostPlanner(encoder, grid,
                       cfg.framework.plan_cache_mb if cache else 0)


def run_planner(cfg: SparseEventIDConfig, grid: Sequence[int],
                cache: bool = False) -> Optional[HostPlanner]:
    """The planner of the config's sparse classifier on ``grid`` (the
    geometry of every sparse task's encoder but SimCLR's views), or None
    when its plans are built on the device or it has none."""
    if not plans_enabled(cfg):
        return None
    return planner_for(cfg, build_sparse_classifier(cfg).encoder, grid, cache)


def task_planner(cfg: SparseEventIDConfig, grid: Sequence[int],
                 cache: bool = False) -> Optional[HostPlanner]:
    """The planner of the plans a task's batches carry, the one choice of
    ``open_run`` (its loaders build them) and ``validate``:
    ``run_planner``'s for supervised_eventID, yolo and
    unsupervised_eventID; None for SimCLR, whose views are planned as they
    are made (``planner_for`` on the views' encoder), and where the plans
    are built on the device."""
    if cfg.name not in ("supervised_eventID", "yolo", "unsupervised_eventID"):
        return None
    return run_planner(cfg, grid, cache)
