"""Carry the JAX package's flax variables into this package's model.

The port's modules carry the flax names, so a parameter's ``state_dict`` key
is its flax path joined with dots.  Flax ``Dense`` kernels are [in, out] and
``nn.Linear`` weights [out, in], so those are transposed; batch-norm running
statistics come from the ``batch_stats`` collection.  Flax ``Conv``
kernels are [kd, kh, kw, Cin, Cout] and ``nn.Conv3d`` weights
[Cout, Cin, kd, kh, kw], so those are permuted (a plain ``.T`` would give
[Cout, Cin, kw, kh, kd], the same shape for a cubic kernel but another
function).  The sparse convs' weights ([K, C, CO] in both) are not
``kernel`` leaves and carry across as they are.
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
    -> the ``state_dict`` of the port's model of the same task
    (``models.build.SparseEventClassifier``, ``train.representation.
    RepresentationModel`` or ``train.vertex.VertexModel``)."""
    out = {}
    for path, arr in _flatten(params):
        if path.endswith(".kernel"):
            path = path[: -len("kernel")] + "weight"
            # Dense [in, out] -> [out, in]; Conv [*k, in, out] -> [out, in, *k]
            n = arr.ndim
            arr = arr.transpose((n - 1, n - 2) + tuple(range(n - 2)))
        out[path] = torch.tensor(arr, dtype=torch.float32)
    for path, arr in _flatten(batch_stats or {}):
        out[path] = torch.tensor(arr, dtype=torch.float32)
    return out
