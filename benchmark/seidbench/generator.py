"""The benchmark's frozen event generator.

A copy, frozen here, of the port's synthetic LArTPC generator
(``io/synthetic.generate_event``) and of its larcv layout
(``io/larcv.synthetic_larcv_event``): a later change to the program's
generator cannot change the traffic.  ``benchmark/tests`` holds the two
equal on today's tree.

Event ``i`` of a pool is drawn from ``np.random.default_rng((seed, i))``,
unnormalized, as a list of projections, each (linear ids u64[n], values
f32[n]): one projection of ids linear in the 3-D grid, or (``planes``) one
wire plane a projection of the (H, H, W) event, ids linear in (H, W).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

LABELS = ("labelneutID", "labelprotID", "labelnpiID", "labelcpiID")


def generate_event(rng: np.random.Generator, image_size: Sequence[int],
                   mean_tracks: float, steps_per_track: int,
                   max_voxels: int):
    """One event -> (coords i32[n, D], values f32[n], labels, aux), never
    normalized (the larcv files' raw charge)."""
    dims = np.array(image_size, dtype=np.float64)
    d = len(dims)
    vertex = rng.uniform(0.25, 0.75, size=d) * dims

    neut_class = int(rng.integers(0, 3))
    n_protons = min(int(rng.poisson(0.8)), 2)
    n_cpi = int(rng.random() < 0.3)
    n_npi = int(rng.random() < 0.25)

    pts = []
    vals = []

    def add_track(start, length, dedx, steps=None, direction=None):
        if direction is None:
            direction = rng.normal(size=d)
            direction /= np.linalg.norm(direction) + 1e-9
        s = np.linspace(0, length, steps or steps_per_track)
        track = start[None, :] + s[:, None] * direction[None, :]
        track += rng.normal(scale=0.5, size=track.shape)
        pts.append(track)
        vals.append(
            np.full(len(track), dedx) * rng.uniform(0.7, 1.3, len(track))
        )
        return start + length * direction

    def add_shower(start, length, n_points, dedx=0.8):
        axis = rng.normal(size=d)
        axis /= np.linalg.norm(axis) + 1e-9
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

    spt = steps_per_track
    scale = max(1.0, mean_tracks / 3.0)
    if neut_class == 0:
        add_shower(
            vertex, rng.uniform(0.25, 0.5) * dims.min(), int(2 * spt)
        )
    elif neut_class == 1:
        add_track(
            vertex, rng.uniform(0.55, 0.9) * dims.min(),
            dedx=rng.uniform(0.8, 1.2), steps=int(1.5 * spt),
        )
    for _ in range(n_protons):
        add_track(
            vertex, rng.uniform(0.05, 0.15) * dims.min(),
            dedx=rng.uniform(2.5, 4.0),
        )
    if n_cpi:
        elbow = add_track(
            vertex, rng.uniform(0.1, 0.3) * dims.min(),
            dedx=rng.uniform(0.9, 1.4),
        )
        add_track(
            np.clip(elbow, 0, dims - 1),
            rng.uniform(0.1, 0.3) * dims.min(),
            dedx=rng.uniform(0.9, 1.4),
        )
    if n_npi:
        for _ in range(2):
            gap_dir = rng.normal(size=d)
            gap_dir /= np.linalg.norm(gap_dir) + 1e-9
            start = vertex + gap_dir * rng.uniform(0.04, 0.1) * dims.min()
            add_shower(
                np.clip(start, 0, dims - 1),
                rng.uniform(0.15, 0.3) * dims.min(), int(1.2 * spt),
            )
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

    if len(coords) > max_voxels:
        keep = np.argsort(vals)[::-1][:max_voxels]
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


def larcv_event(index: int, seed: int, gen: Dict):
    """Event ``index`` of a pool -> (projections, labels, aux).  ``gen``:
    ``image_size``, ``mean_tracks``, ``steps_per_track``, ``max_voxels``
    and ``planes`` (image_size (P, H, W): tracks on (H, H, W), plane p
    projects out axis p % 3, keeps the pixels inside (H, W) and sums the
    charge of the voxels sharing a pixel)."""
    size = tuple(int(v) for v in gen["image_size"])
    planes = bool(gen.get("planes", False))
    gen_size = (size[1],) + size[1:] if planes else size
    coords, vals, labels, aux = generate_event(
        np.random.default_rng((seed, index)), gen_size,
        float(gen["mean_tracks"]), int(gen["steps_per_track"]),
        int(gen["max_voxels"]))
    if not planes:
        lin = coords[:, 0].astype(np.int64)
        for dd in range(1, len(size)):
            lin = lin * size[dd] + coords[:, dd]
        return [(lin.astype(np.uint64), vals)], labels, aux
    h, w = size[1:]
    projections = []
    for p in range(size[0]):
        keep = [a for a in range(3) if a != p % 3]
        c2 = coords[:, keep].astype(np.int64)
        inside = (c2[:, 0] < h) & (c2[:, 1] < w)
        ids, inv = np.unique(c2[inside, 0] * w + c2[inside, 1],
                             return_inverse=True)
        summed = np.zeros(len(ids), np.float32)
        np.add.at(summed, inv, vals[inside])
        projections.append((ids.astype(np.uint64), summed))
    return projections, labels, aux


def larcv_grid(gen: Dict) -> Tuple[int, ...]:
    """The grid a pool's ids are linear in: the image size, or (H, W) of
    wire planes."""
    size = tuple(int(v) for v in gen["image_size"])
    return size[1:] if gen.get("planes", False) else size


def make_pool(n_events: int, seed: int, gen: Dict):
    """-> (events, labels): ``n_events`` events, each a list of
    projections, and the label arrays (``label<producer>`` -> i32[n])."""
    events: List = []
    labels = {k: np.zeros(n_events, np.int32) for k in LABELS}
    for i in range(n_events):
        projections, labs, _aux = larcv_event(i, seed, gen)
        events.append(projections)
        for k in LABELS:
            labels[k][i] = labs[k]
    return events, labels
