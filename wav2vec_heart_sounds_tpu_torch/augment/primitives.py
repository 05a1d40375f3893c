"""Copy of ``wav2vec_heart_sounds_tpu/augment/primitives.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Individual waveform augmentation operations (host/NumPy path).

Behavioral contract from reference src/mpcg_wav2vec/augment/primitives.py:30-123: HPSS
recombination, additive white noise, cubic-spline amplitude warp, time stretch, random
parametric EQ, baseline wander and sinusoidal volume modulation, each returning an
abs-max-normalised signal so they compose. Randomness flows through an explicit
``numpy.random.Generator`` (seedable per call chain) instead of process-global state — the
same discipline the JAX batched twin enforces with PRNG keys.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps
from scipy.interpolate import CubicSpline

from ..signal.normalize import abs_max_normalise
from . import dsp

NOISE_STDS = (0.0001, 0.001, 0.01)

_GLOBAL_RNG = np.random.default_rng()


def default_rng(rng: np.random.Generator | None) -> np.random.Generator:
    return rng if rng is not None else _GLOBAL_RNG


def seed_augmentation(seed: int) -> None:
    """Reseed the module-level fallback generator (tests / reproducible runs)."""
    global _GLOBAL_RNG
    _GLOBAL_RNG = np.random.default_rng(seed)


def randfloat(lo: float, hi: float, rng: np.random.Generator | None = None) -> float:
    return float(default_rng(rng).uniform(lo, hi))


# --- time / amplitude ------------------------------------------------------

def time_stretch(x: np.ndarray, fs: int, rate: float, keep_length: bool = False) -> np.ndarray:
    return dsp.time_stretch(x, fs, rate, keep_length=keep_length)


def random_crop(x: np.ndarray, length: int, rng: np.random.Generator | None = None) -> np.ndarray:
    if len(x) <= length:
        return x
    start = int(default_rng(rng).integers(0, len(x) - length + 1))
    return x[start:start + length]


def add_white_noise(x: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    rng = default_rng(rng)
    std = float(rng.choice(NOISE_STDS))
    gain = rng.uniform(0.0, 0.1)
    return abs_max_normalise(x + gain * rng.normal(0.0, std, x.shape))


def amplitude_warp(x: np.ndarray, num_points: int = 12, amp_range=(0.7, 1.3),
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Convolve with a smooth unit-sum cubic-spline gain curve."""
    rng = default_rng(rng)
    n = len(x)
    control = np.linspace(0, n - 1, num_points)
    amps = rng.uniform(amp_range[0], amp_range[1], size=num_points)
    curve = CubicSpline(control, amps, bc_type="natural")(np.arange(n))
    curve = curve / np.sum(curve)
    return np.convolve(x, curve, mode="same")


def _two_band_sines(n: int, fs: int, amp_lo: float, amp_hi: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Sum of one fast (0.05-0.5 Hz) and one slow (0.001-0.05 Hz) random sinusoid."""
    t = np.arange(n) / fs
    out = np.zeros(n)
    for lo, hi in ((0.05, 0.5), (0.001, 0.05)):
        amp = rng.uniform(amp_lo, amp_hi)
        freq = rng.uniform(lo, hi)
        phase = rng.uniform(0.0, 1.0)
        out += amp * np.sin(2 * np.pi * (freq * t + phase))
    return out


def sinusoidal_envelope(x: np.ndarray, fs: int, a_lo: float = 0.01, a_hi: float = 0.25,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    mod = _two_band_sines(x.size, fs, a_lo, a_hi, default_rng(rng))
    return abs_max_normalise(x * (1.0 + mod))


def baseline_wander(x: np.ndarray, fs: int, rng: np.random.Generator | None = None) -> np.ndarray:
    drift = _two_band_sines(x.size, fs, 0.01, 0.2, default_rng(rng))
    return abs_max_normalise(x + drift)


def parametric_eq(x: np.ndarray, fs: float, low: float, high: float, num_bands: int = 5,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Blend the signal with a stack of random narrow 1st-order band sections."""
    rng = default_rng(rng)
    nyq = fs / 2.0
    # Keep the random band inside the open (0, Nyquist) interval so the design is valid at
    # any sampling rate (the band caps, e.g. 500 Hz for PCG, can touch Nyquist at low fs).
    high = min(high, 0.99 * nyq)
    low = min(low, 0.5 * high)
    coloured = np.asarray(x, dtype=np.float64)
    for _ in range(num_bands):
        b_low = rng.uniform(low, 0.95 * high)
        b_high = float(rng.choice([rng.uniform(b_low + 0.05 * (high - low), high),
                                   min(b_low + (high - low) / num_bands, 0.99 * nyq)]))
        sos = sps.iirfilter(1, [b_low / nyq, b_high / nyq], btype="band",
                            ftype="butter", output="sos")
        coloured = sps.sosfilt(sos, coloured)
    return abs_max_normalise(abs_max_normalise(coloured) / 50.0 + abs_max_normalise(x))


# --- harmonic / percussive recombination -----------------------------------

def hpss_recombine(x: np.ndarray, include_residual: bool = True,
                   rng: np.random.Generator | None = None) -> tuple[np.ndarray, int]:
    """Two-stage HPSS decomposition, randomly re-weighting the parts back together.

    ``include_residual=True`` keeps each stage's spectral residual (7 components — the
    synchronised PCG+ECG variant); ``False`` keeps only the second-stage harmonic/percussive
    parts (4 components — the single-channel PCG variant).
    """
    rng = default_rng(rng)
    n_fft1 = int(rng.choice([512, 1024, 2048]))
    hop1 = int(rng.choice([16, 32, 64, 128]))
    n_fft2 = int(rng.choice([512, 1024, 2048]))
    hop2 = int(rng.choice([16, 32, 64, 128]))
    margin1 = (rng.uniform(1.0, 2.0), rng.uniform(1.0, 2.0))
    margin2 = (rng.uniform(1.0, 4.0), rng.uniform(1.0, 4.0))
    kernel1 = (int(rng.integers(5, 31)), int(rng.integers(5, 31)))
    kernel2 = (int(rng.integers(5, 31)), int(rng.integers(5, 31)))

    harm, perc, resid = dsp.hpss_split(x, n_fft1, hop1, margin1, kernel1)
    h1, p1, r1 = dsp.hpss_split(harm, n_fft2, hop2, margin2, kernel2)
    h2, p2, r2 = dsp.hpss_split(perc, n_fft2, hop2, margin2, kernel2)

    parts = [h1, p1, r1, h2, p2, r2, resid] if include_residual else [h1, p1, h2, p2]
    n = min(len(p) for p in parts)
    parts = [p[:n] for p in parts]

    mix1 = abs_max_normalise(sum(rng.uniform(0.01, 10) * p for p in parts))
    mix2 = abs_max_normalise(sum(rng.uniform(0.01, 10) * abs_max_normalise(p) for p in parts))
    return abs_max_normalise(mix1 + rng.uniform(0.01, 0.05) * mix2), n
