"""Post-hoc physics analysis helpers (a copy of the JAX package's
``utils/analysis.py``) — parity with
/root/reference/analysis/dune/tools.py:37-80 (efficiency, confusion matrix,
ROC curves over the 4-head predictions), numpy-only so they run anywhere.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def confusion_matrix(
    labels: np.ndarray, predictions: np.ndarray, n_classes: int
) -> np.ndarray:
    """[n_classes, n_classes] counts, rows = truth, cols = prediction."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (labels.astype(np.int64), predictions.astype(np.int64)), 1)
    return cm


def efficiency_purity(
    labels: np.ndarray, predictions: np.ndarray, n_classes: int
) -> Dict[str, np.ndarray]:
    """Per-class efficiency (recall) and purity (precision)."""
    cm = confusion_matrix(labels, predictions, n_classes)
    eff = np.divide(
        np.diag(cm), cm.sum(axis=1),
        out=np.zeros(n_classes), where=cm.sum(axis=1) > 0,
    )
    pur = np.divide(
        np.diag(cm), cm.sum(axis=0),
        out=np.zeros(n_classes), where=cm.sum(axis=0) > 0,
    )
    return {"efficiency": eff, "purity": pur, "confusion": cm}


def roc_curve(
    labels: np.ndarray, scores: np.ndarray, signal_class: int = 1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) for one-vs-rest on softmax scores [N, C]."""
    sig = labels == signal_class
    s = scores[:, signal_class]
    order = np.argsort(-s)
    sig = sig[order]
    tps = np.cumsum(sig)
    fps = np.cumsum(~sig)
    tpr = tps / max(sig.sum(), 1)
    fpr = fps / max((~sig).sum(), 1)
    return fpr, tpr, s[order]


def auc(fpr: np.ndarray, tpr: np.ndarray) -> float:
    return float(np.trapezoid(tpr, fpr))


def summarize_predictions(
    outputs: Mapping[str, np.ndarray], labels: Mapping[str, np.ndarray]
) -> Dict[str, Dict]:
    """Per-head efficiency/purity/AUC over saved softmax outputs
    (the inference-mode npz / larcv writer contents)."""
    summary = {}
    for key, scores in outputs.items():
        lab = np.asarray(labels[key])
        pred = scores.argmax(axis=-1)
        stats = efficiency_purity(lab, pred, scores.shape[-1])
        fpr, tpr, _ = roc_curve(lab, scores, signal_class=min(1, scores.shape[-1] - 1))
        stats["auc"] = auc(fpr, tpr)
        stats["accuracy"] = float((pred == lab).mean())
        summary[key] = stats
    return summary
