"""Synthetic sparse-event generator (numpy), a copy of the JAX package's
``io/synthetic.py`` so that both packages see the same events for a seed.

Events mimic LArTPC topology: a handful of straight tracks and showers
radiating from a vertex, voxelized onto the detector grid, with per-voxel
energy depositions.  Labels for the four classification heads are derived
from the generated particle content.  Batches are larcv-style padded
arrays: coords [B, MaxVoxels, D] with -999 fill, plus values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..config.schema import OUTPUT_SHAPE


@dataclasses.dataclass
class SyntheticEventConfig:
    image_size: Tuple[int, ...] = (64, 64, 64)
    n_planes: int = 1  # >1 -> 2D multiplane projections [B,P,MaxVoxels,3]
    max_voxels: int = 2048
    mean_tracks: float = 3.0
    steps_per_track: int = 200
    normalize: bool = True  # larcv Normalize: Mean=1.0 Std=0.5 (larcv_fetcher.py:100-108)


def generate_event(
    rng: np.random.Generator, cfg: SyntheticEventConfig
) -> Tuple[np.ndarray, np.ndarray, Dict[str, int], Dict[str, np.ndarray]]:
    """One event -> (coords i32[<=max_voxels, D], values f32[n], labels, aux).

    aux carries the per-event targets the non-supervised tasks need:
    ``vertex`` (true interaction vertex, voxel units — the yolo task's
    regression target, vertex_finding.py:294-359) and ``energy`` (total
    deposition — the unsupervised task's weak-label feature,
    unsupervised_eventID.py:360)."""
    dims = np.array(cfg.image_size, dtype=np.float64)
    d = len(dims)
    vertex = rng.uniform(0.25, 0.75, size=d) * dims

    # particle content drives the labels
    neut_class = int(rng.integers(0, 3))  # neutrino flavor: 3 classes
    n_protons = min(int(rng.poisson(0.8)), 2)  # 0, 1, 2+ -> 3 classes
    n_cpi = int(rng.random() < 0.3)  # charged pion present: 2 classes
    n_npi = int(rng.random() < 0.25)  # neutral pion present: 2 classes

    # Each label leaves a TOPOLOGICAL signature (the discriminants real
    # LArTPC classifiers use), so every head is learnable from shape, not
    # just multiplicity (r3's count-only generator left neutID near its
    # Bayes limit ~55%):
    #   nu_e CC  -> EM shower cone at the vertex
    #   nu_mu CC -> one long straight MIP track
    #   NC       -> hadronic stubs only
    #   proton   -> short straight track with high dE/dx (kept from r3)
    #   pi+-     -> kinked track (two segments sharing an endpoint)
    #   pi0      -> two DISPLACED photon showers (conversion gap)
    pts = []
    vals = []

    def add_track(start, length, dedx, steps=None, direction=None):
        if direction is None:
            direction = rng.normal(size=d)
            direction /= np.linalg.norm(direction) + 1e-9
        s = np.linspace(0, length, steps or cfg.steps_per_track)
        track = start[None, :] + s[:, None] * direction[None, :]
        track += rng.normal(scale=0.5, size=track.shape)  # diffusion
        pts.append(track)
        vals.append(
            np.full(len(track), dedx) * rng.uniform(0.7, 1.3, len(track))
        )
        return start + length * direction

    def add_shower(start, length, n_points, dedx=0.8):
        axis = rng.normal(size=d)
        axis /= np.linalg.norm(axis) + 1e-9
        # cone: longitudinal profile with transverse spread growing along
        # the axis (Moliere-radius-like) — visually distinct from tracks
        t = rng.uniform(0, 1, n_points) ** 0.7 * length
        perp = rng.normal(size=(n_points, d))
        perp -= (perp @ axis)[:, None] * axis[None, :]
        spread = 0.05 * length + 0.22 * t
        shower = start[None, :] + t[:, None] * axis[None, :]
        shower += perp * (spread / (np.linalg.norm(perp, axis=1) + 1e-9))[
            :, None
        ]
        pts.append(shower)
        vals.append(
            np.full(n_points, dedx) * rng.uniform(0.5, 1.5, n_points)
        )

    spt = cfg.steps_per_track
    scale = max(1.0, cfg.mean_tracks / 3.0)  # occupancy multiplier
    if neut_class == 0:  # nu_e CC: EM shower at the vertex
        add_shower(
            vertex, rng.uniform(0.25, 0.5) * dims.min(), int(2 * spt)
        )
    elif neut_class == 1:  # nu_mu CC: one long MIP track
        add_track(
            vertex, rng.uniform(0.55, 0.9) * dims.min(),
            dedx=rng.uniform(0.8, 1.2), steps=int(1.5 * spt),
        )
    for _ in range(n_protons):  # short, high dE/dx stubs
        add_track(
            vertex, rng.uniform(0.05, 0.15) * dims.min(),
            dedx=rng.uniform(2.5, 4.0),
        )
    if n_cpi:  # charged pion: kinked track
        elbow = add_track(
            vertex, rng.uniform(0.1, 0.3) * dims.min(),
            dedx=rng.uniform(0.9, 1.4),
        )
        add_track(
            np.clip(elbow, 0, dims - 1),
            rng.uniform(0.1, 0.3) * dims.min(),
            dedx=rng.uniform(0.9, 1.4),
        )
    if n_npi:  # neutral pion: two displaced photon showers
        for _ in range(2):
            gap_dir = rng.normal(size=d)
            gap_dir /= np.linalg.norm(gap_dir) + 1e-9
            start = vertex + gap_dir * rng.uniform(0.04, 0.1) * dims.min()
            add_shower(
                np.clip(start, 0, dims - 1),
                rng.uniform(0.15, 0.3) * dims.min(), int(1.2 * spt),
            )
    # hadronic background stubs; count scales the event to detector
    # occupancy (mean_tracks=40 -> ~25k voxels, the bench distribution)
    n_bg = max(1, int(rng.poisson(1 + 2.8 * scale)))
    for _ in range(n_bg):
        add_track(
            vertex, rng.uniform(0.1, 0.45) * dims.min(),
            dedx=rng.uniform(0.5, 2.0),
        )
    pts = np.concatenate(pts)
    vals = np.concatenate(vals)

    ok = np.all((pts >= 0) & (pts < dims[None, :]), axis=1)
    coords = np.floor(pts[ok]).astype(np.int32)
    vals = vals[ok].astype(np.float32)

    # dedup voxels, summing deposition (what TensorFromCluster3D does)
    if len(coords):
        lin = coords[:, 0].astype(np.int64)
        for k in range(1, d):
            lin = lin * int(dims[k]) + coords[:, k]
        uniq, inv = np.unique(lin, return_inverse=True)
        summed = np.zeros(len(uniq), np.float32)
        np.add.at(summed, inv, vals)
        first = np.zeros(len(uniq), np.int64)
        first[inv[::-1]] = np.arange(len(coords))[::-1]
        coords = coords[first]
        vals = summed

    if cfg.normalize and len(vals):
        # larcv Normalize process: shift/scale to Mean=1.0 Std=0.5
        mu, sd = vals.mean(), vals.std() + 1e-6
        vals = (vals - mu) / sd * 0.5 + 1.0

    if len(coords) > cfg.max_voxels:  # larcv truncates at MaxVoxels
        keep = np.argsort(vals)[::-1][: cfg.max_voxels]
        coords, vals = coords[keep], vals[keep]

    labels = {
        "labelneutID": neut_class,
        "labelprotID": min(n_protons, 2),
        "labelcpiID": n_cpi,
        "labelnpiID": n_npi,
    }
    aux = {
        "vertex": vertex.astype(np.float32),
        "energy": np.float32(vals.sum()),
    }
    return coords, vals, labels, aux


class SyntheticDataset:
    """Finite, indexable synthetic dataset with the larcv_dataset interface
    surface (image_size / __len__ / batch iteration)."""

    def __init__(
        self,
        n_events: int,
        cfg: SyntheticEventConfig | None = None,
        seed: int = 0,
    ):
        self.cfg = cfg or SyntheticEventConfig()
        self.n_events = n_events
        self.seed = seed

    def __len__(self) -> int:
        return self.n_events

    def image_size(self) -> Tuple[int, ...]:
        """The 3D volume the tracks are generated in."""
        return tuple(self.cfg.image_size)

    def batch_grid(self) -> Tuple[int, ...]:
        """The grid the batches' coordinates live on: the generation volume,
        or (planes, H, W) for multiplane projections of an (H, H, W) one."""
        size = self.image_size()
        p = self.cfg.n_planes
        return (p,) + size[1:] if p > 1 else size

    def event(self, index: int):
        rng = np.random.default_rng((self.seed, index % self.n_events))
        return generate_event(rng, self.cfg)

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """Padded larcv-style batch dict: image [B, MaxVoxels, D+1] (3D) or
        [B, planes, MaxVoxels, 3] (2D multiplane projections of the 3D
        event, mirroring BatchFillerSparseTensor2D) with -999 fill + int
        label arrays."""
        b = len(indices)
        d = len(self.cfg.image_size)
        labels = {k: np.zeros(b, np.int32) for k in OUTPUT_SHAPE}
        if self.cfg.n_planes > 1:
            p = self.cfg.n_planes
            image = np.full((b, p, self.cfg.max_voxels, 3), -999.0, np.float32)
            energy = np.zeros(b, np.float32)
            for i, idx in enumerate(indices):
                coords, vals, labs, aux = self.event(int(idx))
                energy[i] = aux["energy"]
                for pl in range(p):
                    # project out axis pl%d -> a 2D wire-plane view
                    keep = [a for a in range(d) if a != (pl % d)]
                    c2 = coords[:, keep]
                    # dedup projected pixels, summing charge
                    lin = c2[:, 0].astype(np.int64) * 4096 + c2[:, 1]
                    uniq, inv = np.unique(lin, return_inverse=True)
                    summed = np.zeros(len(uniq), np.float32)
                    np.add.at(summed, inv, vals)
                    c2u = np.stack([uniq // 4096, uniq % 4096], -1)
                    n = min(len(c2u), self.cfg.max_voxels)
                    # larcv stores (x, y, value); the scn coordinate order is
                    # [plane, y, x] (data_transforms.py:242), so the FIRST
                    # projected axis is y and the SECOND is x here.
                    image[i, pl, :n, 0] = c2u[:n, 1]
                    image[i, pl, :n, 1] = c2u[:n, 0]
                    image[i, pl, :n, 2] = summed[:n]
                for k, v in labs.items():
                    labels[k][i] = v
            out = {
                "image": image,
                "energy": energy,
                "index": np.asarray(indices, np.int64),
            }
            out.update(labels)
            return out
        image = np.full((b, self.cfg.max_voxels, d + 1), -999.0, np.float32)
        vertex = np.zeros((b, d), np.float32)
        energy = np.zeros(b, np.float32)
        for i, idx in enumerate(indices):
            coords, vals, labs, aux = self.event(int(idx))
            n = len(coords)
            image[i, :n, :d] = coords
            image[i, :n, d] = vals
            vertex[i] = aux["vertex"]
            energy[i] = aux["energy"]
            for k, v in labs.items():
                labels[k][i] = v
        out = {
            "image": image,
            "vertex": vertex,
            "energy": energy,
            "index": np.asarray(indices, np.int64),
        }
        out.update(labels)
        return out
