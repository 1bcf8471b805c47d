"""Carry the JAX package's flax variables into this package's model.

The port's modules carry the flax names, so a parameter's ``state_dict`` key
is its flax path joined with dots.  Flax ``Dense`` kernels are [in, out] and
``nn.Linear`` weights [out, in], so those are transposed; batch-norm running
statistics come from the ``batch_stats`` collection.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def params_from_jax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> Dict[str, torch.Tensor]:
    """Flax ``params`` / ``batch_stats`` trees (nested dicts of numpy arrays)
    -> the ``state_dict`` of ``models.build.SparseEventClassifier``."""
    out = {}
    for path, arr in _flatten(params):
        if path.endswith(".kernel"):
            path = path[: -len("kernel")] + "weight"
            arr = arr.T
        out[path] = torch.tensor(arr, dtype=torch.float32)
    for path, arr in _flatten(batch_stats or {}):
        out[path] = torch.tensor(arr, dtype=torch.float32)
    return out
