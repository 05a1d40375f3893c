"""Copy of ``wav2vec_heart_sounds_tpu/augment/pipelines.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Probabilistic augmentation pipelines per modality (host/NumPy path).

Behavioral contract from reference src/mpcg_wav2vec/augment/pipelines.py:22-148: per-modality
compositions with the paper's application probabilities (hpss .75, noise .30 split /4 per
application, time-warp .25, wandering-volume .75, banding .25, baseline-wander .30, real-noise
.5); the synchronised PCG+ECG pipeline shares one stretch rate and truncates the ECG to the
HPSS output length; the vest pipeline applies identical transforms to all channels to preserve
inter-channel phase.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..signal.normalize import abs_max_normalise, minmax_normalise
from . import primitives as P
from .noise_sources import ecg_noise, pcg_noise
from .primitives import default_rng

# Stretch-rate ranges: near-identity micro-stretch for single PCG, wider for the pair.
PCG_STRETCH = (1.004, 1.006)
PAIR_STRETCH = (0.8, 1.2)


@dataclass
class AugmentConfig:
    ephnogram_dir: str = ""
    mit_dir: str = ""
    prob_hpss: float = 0.75
    prob_noise: float = 0.30            # split across applications (prob_noise / 4 each)
    prob_time_warp: float = 0.25
    prob_wandering_volume: float = 0.75
    prob_banding: float = 0.25
    prob_baseline_wander: float = 0.30
    prob_real_noise: float = 0.5


def _chance(p: float, rng: np.random.Generator) -> bool:
    return bool(rng.random() < p)


def augment_pcg(pcg: np.ndarray, fs: int, cfg: AugmentConfig | None = None,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Single-channel PCG augmentation (4-component HPSS, micro time-stretch)."""
    cfg = cfg or AugmentConfig()
    rng = default_rng(rng)
    x = minmax_normalise(pcg.copy())
    if _chance(cfg.prob_hpss, rng):
        x, _ = P.hpss_recombine(x, include_residual=False, rng=rng)
    if _chance(cfg.prob_noise / 4, rng):
        x = P.add_white_noise(x, rng)
    if _chance(cfg.prob_time_warp, rng):
        x = abs_max_normalise(P.time_stretch(x, fs, P.randfloat(*PCG_STRETCH, rng=rng)))
    if _chance(cfg.prob_wandering_volume, rng):
        x = P.sinusoidal_envelope(x, fs, rng=rng)
    if _chance(cfg.prob_noise / 4, rng):
        x = P.add_white_noise(x, rng)
    if _chance(cfg.prob_banding, rng):
        x = P.parametric_eq(x, fs, 2, 500, rng=rng)
    if _chance(cfg.prob_real_noise, rng) and cfg.ephnogram_dir:
        x = x + pcg_noise(fs, len(x), cfg.ephnogram_dir, rng)
    return abs_max_normalise(x)


def augment_ecg(ecg: np.ndarray, fs: int, cfg: AugmentConfig | None = None,
                rng: np.random.Generator | None = None) -> np.ndarray:
    cfg = cfg or AugmentConfig()
    rng = default_rng(rng)
    x = minmax_normalise(ecg.copy())
    if _chance(cfg.prob_noise / 4, rng):
        x = P.add_white_noise(x, rng)
    if _chance(cfg.prob_baseline_wander, rng):
        x = P.baseline_wander(x, fs, rng)
    if _chance(cfg.prob_time_warp, rng):
        x = abs_max_normalise(P.time_stretch(x, fs, P.randfloat(*PAIR_STRETCH, rng=rng)))
    if _chance(cfg.prob_noise / 4, rng):
        x = P.add_white_noise(x, rng)
    if _chance(cfg.prob_banding, rng):
        x = P.parametric_eq(x, fs, 0.25, 100, rng=rng)
    if _chance(cfg.prob_real_noise, rng) and cfg.mit_dir:
        x = x + ecg_noise(fs, len(x), cfg.mit_dir, rng)
    return abs_max_normalise(x)


def augment_pcg_ecg(ecg: np.ndarray, pcg: np.ndarray, fs: int,
                    cfg: AugmentConfig | None = None,
                    rng: np.random.Generator | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Jointly augment a synchronised ECG/PCG pair (7-component HPSS, shared stretch rate)."""
    cfg = cfg or AugmentConfig()
    rng = default_rng(rng)
    e = minmax_normalise(ecg.copy())
    p = minmax_normalise(pcg.copy())

    if _chance(cfg.prob_hpss, rng):
        p, n = P.hpss_recombine(p, include_residual=True, rng=rng)
        e = e[:n]
    if _chance(cfg.prob_noise / 4, rng):
        p = P.add_white_noise(p, rng)
    if _chance(cfg.prob_noise / 4, rng):
        e = P.add_white_noise(e, rng)
    if _chance(cfg.prob_baseline_wander, rng):
        e = P.baseline_wander(e, fs, rng)
    if _chance(cfg.prob_time_warp, rng):
        rate = P.randfloat(*PAIR_STRETCH, rng=rng)
        e = abs_max_normalise(P.time_stretch(e, fs, rate))
        p = abs_max_normalise(P.time_stretch(p, fs, rate))
    if _chance(cfg.prob_wandering_volume, rng):
        p = P.sinusoidal_envelope(p, fs, rng=rng)
    if _chance(cfg.prob_noise / 4, rng):
        p = P.add_white_noise(p, rng)
    if _chance(cfg.prob_noise / 4, rng):
        e = P.add_white_noise(e, rng)
    if _chance(cfg.prob_banding, rng):
        p = P.parametric_eq(p, fs, 2, 500, rng=rng)
    if _chance(cfg.prob_banding, rng):
        e = P.parametric_eq(e, fs, 0.25, 100, rng=rng)
    if _chance(cfg.prob_real_noise, rng) and cfg.mit_dir:
        e = e + ecg_noise(fs, len(e), cfg.mit_dir, rng)
    if _chance(cfg.prob_real_noise, rng) and cfg.ephnogram_dir:
        p = p + pcg_noise(fs, len(p), cfg.ephnogram_dir, rng)
    return abs_max_normalise(e), abs_max_normalise(p)


# Vest / multichannel probabilities (channels augmented identically to keep phase).
MULTI_PROB_NOISE = 0.30
MULTI_PROB_TIME_WARP = 0.35
MULTI_PROB_WANDER = 0.75
MULTI_PROB_REAL_NOISE = 0.25
MULTI_STRETCH = (0.7, 1.3)


def augment_multi_pcg(channels: list[np.ndarray], fs: int,
                      cfg: AugmentConfig | None = None,
                      rng: np.random.Generator | None = None) -> list[np.ndarray]:
    """Augment every PCG channel identically so cross-channel timing is preserved."""
    cfg = cfg or AugmentConfig()
    rng = default_rng(rng)
    chans = [abs_max_normalise(c.copy()) for c in channels]

    if _chance(MULTI_PROB_NOISE / 4, rng):
        chans = [P.add_white_noise(c, rng) for c in chans]
    if _chance(MULTI_PROB_TIME_WARP, rng):
        rate = P.randfloat(*MULTI_STRETCH, rng=rng)
        chans = [abs_max_normalise(P.time_stretch(c, fs, rate, keep_length=True)) for c in chans]
    if _chance(MULTI_PROB_WANDER, rng):
        mod = P._two_band_sines(chans[0].size, fs, 0.01, 0.25, rng)
        chans = [abs_max_normalise(c * (1.0 + mod)) for c in chans]
    if _chance(MULTI_PROB_NOISE / 4, rng):
        chans = [P.add_white_noise(c, rng) for c in chans]
    if _chance(MULTI_PROB_REAL_NOISE, rng) and cfg.ephnogram_dir:
        shared = pcg_noise(fs, len(chans[0]), cfg.ephnogram_dir, rng)
        chans = [abs_max_normalise(c + shared) for c in chans]
    return chans
