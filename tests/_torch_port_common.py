"""Shared inputs for the tests that hold the PyTorch port against the JAX
package: the same numpy data, made from a seed, goes to both."""

import jax.numpy as jnp
import numpy as np
import torch

from sparseeventid_tpu import ops as jops
from sparseeventid_tpu_torch import ops as tops


def random_coo(seed=0, b=2, n=512, grid=(16, 16, 16), c=8, density=0.08,
               integer=True, n_live=None):
    """Unsorted padded COO (coords -1 at padding) with integer-valued (or
    normal) features.  ``n_live`` overrides the live count per element."""
    rng = np.random.default_rng(seed)
    coords = np.full((b, n, 3), -1, np.int32)
    feats = np.zeros((b, n, c), np.float32)
    total = int(np.prod(grid))
    for bi in range(b):
        m = min(n, int(total * density))
        if n_live is not None:
            m = n_live[bi]
        lin = rng.choice(total, m, replace=False)
        coords[bi, :m] = np.stack(np.unravel_index(lin, grid), -1)
        if integer:
            feats[bi, :m] = rng.integers(-3, 4, (m, c))
        else:
            feats[bi, :m] = rng.standard_normal((m, c))
    return coords, feats


def line_coo(c=4, seed=2):
    """One event whose matches span far in key order, so window plans must
    push pairs to the overflow list (the forced-overflow geometry of
    tests/test_window_engine.py)."""
    rng = np.random.default_rng(seed)
    grid = (64, 64, 64)
    n = 256
    pts = [(0, 0, z) for z in range(60)] + [(63, 0, z) for z in range(60)]
    pts += [(x, 32, 32) for x in range(63)]
    pts = np.array(sorted(set(pts)), np.int32)
    coords = np.full((1, n, 3), -1, np.int32)
    feats = np.zeros((1, n, c), np.float32)
    coords[0, : len(pts)] = pts
    feats[0, : len(pts)] = rng.integers(-3, 4, (len(pts), c))
    return coords, feats, grid


def both(coords, feats, grid, capacity=None):
    """(JAX SparseTensor, port SparseTensor) of the same data."""
    sj = jops.build_sparse_tensor(
        jnp.asarray(coords), jnp.asarray(feats), grid, capacity=capacity
    )
    st = tops.build_sparse_tensor(
        torch.from_numpy(coords), torch.from_numpy(feats), grid,
        capacity=capacity,
    )
    return sj, st


def t(x) -> torch.Tensor:
    """A JAX array as a torch tensor (bool stays bool)."""
    return torch.from_numpy(np.array(x))


def int_weights(seed, shape):
    return np.random.default_rng(seed).integers(-2, 3, shape).astype(np.float32)


def assert_equal(got: torch.Tensor, want) -> None:
    """Bit-equal comparison of a port tensor with a JAX array."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
