"""Unsupervised (weak-label) event ID, a copy of the JAX package's
``train/unsupervised.py`` (numpy and scipy in both): an exponentially
modified Gaussian fitted to the deposited-energy spectrum places a signal
window, mu +- 2 sigma around the peak (the 30th-70th percentiles where the
fit fails), and the events inside it get weak label 1.  The trainer then
trains the classifier's single ``weak_label`` head on those labels with the
supervised step.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def expgauss(x, a, mu, sigma, lam):
    """Exponentially modified Gaussian (unsupervised_eventID.py:24-40)."""
    from scipy.special import erfc

    z = (mu + lam * sigma**2 - x) / (np.sqrt(2) * sigma)
    return (
        a
        * lam
        / 2.0
        * np.exp(lam / 2.0 * (2 * mu + lam * sigma**2 - 2 * x))
        * erfc(z)
    )


def fit_energy_spectrum(
    energies: np.ndarray,
    n_bins: int = 100,
    p0=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fit an expgauss to the deposited-energy spectrum; returns (params,
    bin_centers).  Used to locate the signal peak for weak labeling."""
    from scipy.optimize import curve_fit

    hist, edges = np.histogram(energies, bins=n_bins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    if p0 is None:
        mu0 = centers[np.argmax(hist)]
        p0 = [hist.max(), mu0, (edges[-1] - edges[0]) / 20.0, 1.0]
    params, _ = curve_fit(
        expgauss, centers, hist, p0=p0, maxfev=20000
    )
    return params, centers


def weak_labels_from_energy(
    energies: np.ndarray,
    signal_window: Tuple[float, float] | None = None,
) -> Dict[str, np.ndarray]:
    """Assign weak signal/background labels by energy window.  If no window
    is given, fit the spectrum and take mu +- 2 sigma around the peak."""
    if signal_window is None:
        try:
            params, _ = fit_energy_spectrum(energies)
            _, mu, sigma, _ = params
            signal_window = (mu - 2 * abs(sigma), mu + 2 * abs(sigma))
        except Exception:
            lo, hi = np.percentile(energies, [30, 70])
            signal_window = (lo, hi)
    lo, hi = signal_window
    labels = ((energies >= lo) & (energies <= hi)).astype(np.int32)
    return {"weak_label": labels, "window": np.asarray(signal_window)}
