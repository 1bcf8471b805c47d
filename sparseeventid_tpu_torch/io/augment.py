"""On-read augmentations, a copy of the JAX package's ``io/augment.py`` (numpy
in both, so one ``np.random.Generator`` state gives the same view) — parity
with the reference's larcv augment chain
(reference src/io/larcv_fetcher.py:229-261: Mirror -> GaussianBlur
sigma=0.05 -> Translate within +-[15, 15, 25]), applied host-side to padded
COO batches to produce the two SimCLR views (producers <key>_1 / <key>_2)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def augment_larcv_batch(
    image: np.ndarray,  # [B, MaxVoxels, D+1], -999 padded
    image_size: Tuple[int, ...],
    rng: np.random.Generator,
    mirror: bool = True,
    blur_sigma: float = 0.05,
    translate: Sequence[int] | None = None,
) -> np.ndarray:
    """One augmented view; same shape/padding contract as the input.

    translate defaults to the reference's +-(15, 15, 25) scaled down for
    small grids (shifts are clamped to ~grid/8 so views stay populated)."""
    if translate is None:
        translate = [min(t, max(1, g // 8)) for t, g in
                     zip((15, 15, 25), image_size)]
    out = image.copy()
    b = image.shape[0]
    d = len(image_size)
    coords = out[..., :d]
    vals = out[..., d]
    valid = np.all(coords != -999.0, axis=-1)
    dims = np.asarray(image_size, np.float32)
    for bi in range(b):
        m = valid[bi]
        if not m.any():
            continue
        c = coords[bi][m]
        v = vals[bi][m]
        if mirror:
            for ax in range(d):
                if rng.random() < 0.5:
                    c[:, ax] = dims[ax] - 1 - c[:, ax]
        if blur_sigma > 0:
            # larcv GaussianBlur: jitter voxel positions
            c = c + rng.normal(scale=blur_sigma, size=c.shape)
        shift = np.array(
            [rng.integers(-t, t + 1) for t in translate[:d]], np.float32
        )
        c = np.rint(c + shift)
        inside = np.all((c >= 0) & (c < dims), axis=-1)
        c, v = c[inside], v[inside]
        coords[bi] = -999.0
        vals[bi] = -999.0
        k = len(c)
        coords[bi, :k] = c
        vals[bi, :k] = v
    return out
