"""Build and load the CUDA kernels of ``sparseeventid_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/torch_kernels/`` at the
repository root, and loaded with ctypes.  The library's file name carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built at import: the first launch
builds what it needs, and ``build_all`` builds every kernel at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = ROOT / "build" / "torch_kernels"
SOURCES = ("window_plan", "window_conv", "overflow_apply", "window_bwd",
           "window_dw", "overflow_dw", "window_gather", "gather_conv",
           "masked_norm", "knn", "edge_conv")
# headers a source includes: an edited header rebuilds every source
HEADERS = ("window_match.cuh", "window_tc.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the arguments window_conv and window_dw share, up to the batch size
_WINDOW = [_P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _P,
           _P, _I]
SIGNATURES = {
    "seid_window_plan": [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    # then the offset groups and the stream
    "seid_window_conv_f32": _WINDOW + [_I, _P],
    # then the slab (output columns a task takes), the grid and the stream
    "seid_overflow_apply_f32": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P,
                                _P, _P, _I, _I, _I, _I, _P],
    # then the dX offset groups, the dW scratch, its parts and the stream
    "seid_window_bwd_f32": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I,
                            _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I,
                            _P],
    # then the scratch, its parts, the piece (offsets, channels), the stream
    "seid_overflow_dw_f32": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                             _P, _I, _I, _P, _I, _I, _I, _P],
    "seid_window_gather_f32": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _P, _I,
                               _P, _P, _P, _I, _P],
    # then the offset groups and the stream
    "seid_gather_conv_f32": [_P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P],
}
# window_dw takes gy where the conv takes w and dw for out, then its
# partials' scratch, their count, the offset groups and the stream
SIGNATURES["seid_window_dw_f32"] = _WINDOW + [_P, _I, _I, _P]
# the batch norm's: rows (feats, n_active, B, N, C) and the launch shape
# (vec, threads, per_block, grid); then each entry's own, and the stream
_ROWS = [_P, _P, _I, _I, _I, _I, _I, _I, _I]
SIGNATURES.update({
    "seid_bn_stats_f32": _ROWS + [_P, _P, _P],
    "seid_bn_apply_f32": _ROWS + [_P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _F,
                                  _P, _P, _P],
    # the backward's take the gradient first
    "seid_bn_bwd_reduce_f32": [_P] + _ROWS + [_P, _P, _P, _I, _F, _P, _P, _P],
    "seid_bn_bwd_apply_f32": [_P] + _ROWS + [_P, _P, _P, _I, _F, _P, _I, _P,
                                             _P],
})
for _name in [n for n in SIGNATURES if n.endswith("_f32")]:
    SIGNATURES[_name[:-3] + "bf16"] = SIGNATURES[_name]
# float32 only: x, mask, N, P, F, k, out, the stream; the counting entry
# takes its counts before the stream
SIGNATURES["seid_knn_topk_f32"] = [_P, _P, _I, _I, _I, _I, _P, _P]
SIGNATURES["seid_knn_topk_counts_f32"] = [_P, _P, _I, _I, _I, _I, _P, _P, _P]
# the edge conv's, float32 only: ab, idx, mask, (N, P, C, K) and the launch
# shape (vec, threads, per_block, grid), then each entry's own
_EDGES = [_I] * 8
SIGNATURES["seid_edge_conv_fwd_f32"] = (
    [_P, _P, _P] + _EDGES + [_P] * 4 + [_F] * 3 + [_I, _F] + [_P] * 6)
# the backward's take dy first and out, saved, scale, bias after the mask
SIGNATURES["seid_edge_conv_bwd_f32"] = (
    [_P] * 8 + _EDGES + [_I, _F] + [_P] * 3 + [_I] + [_P] * 8)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} on a machine with the CUDA toolkit"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in HEADERS:
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every kernel not built yet, one nvcc per source in parallel.
    Returns {name: ptxas report}; raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        if name not in _libs:
            build_all((name,))
            dll = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES.items():
                if hasattr(dll, fn):
                    getattr(dll, fn).argtypes = argtypes
                    getattr(dll, fn).restype = ctypes.c_int
            _libs[name] = dll
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
