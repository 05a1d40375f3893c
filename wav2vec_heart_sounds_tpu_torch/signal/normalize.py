"""Copy of ``wav2vec_heart_sounds_tpu/signal/normalize.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Amplitude normalisers (oracle): abs-max, min-max, z-score, k-peak, NaN interpolation.

Behavioral contract from reference src/mpcg_wav2vec/signalproc/normalize.py:11-84. The JAX
batched variants live in :mod:`..ops.normalize`.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def interpolate_nans(x: np.ndarray) -> np.ndarray:
    """Linear interpolation over NaN runs (returns a float64 copy)."""
    x = np.asarray(x, dtype=np.float64).copy()
    bad = np.isnan(x)
    if bad.any() and (~bad).any():
        x[bad] = np.interp(np.flatnonzero(bad), np.flatnonzero(~bad), x[~bad])
    return x


def abs_max_normalise(x: np.ndarray) -> np.ndarray:
    """The canonical normaliser: NaN-fix, zero-mean, divide by peak, clip to [-1, 1]."""
    x = interpolate_nans(x)
    x = x - x.mean()
    peak = np.abs(x).max()
    if peak > 0:
        x = x / peak
    return np.clip(x, -1.0, 1.0)


def minmax_normalise(x: np.ndarray, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    span = x.max() - x.min()
    if span <= 0:
        return np.full_like(x, 0.5 * (lo + hi))
    return (x - x.min()) / span * (hi - lo) + lo


def z_normalise(x: np.ndarray, axis: int = 0) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return (x - x.mean(axis=axis)) / (x.std(axis=axis) + EPS)


def kpeak_normalise(x: np.ndarray, k: int = 3, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Rescale by the mean of the k most extreme samples at either end (spike-robust)."""
    x = np.asarray(x, dtype=np.float64)
    ordered = np.sort(x)
    lo_ref, hi_ref = ordered[:k].mean(), ordered[-k:].mean()
    span = hi_ref - lo_ref
    if span <= 0:
        return np.full_like(x, 0.5 * (lo + hi))
    return lo + (x - lo_ref) / span * (hi - lo)
