"""Copy of ``wav2vec_heart_sounds_tpu/augment/dsp.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Self-contained DSP for augmentation: complex STFT/ISTFT, median-filter HPSS, and a
phase-vocoder time stretch.

The reference delegated these to librosa (HPSS) and pyrubberband (stretch) —
reference src/mpcg_wav2vec/augment/primitives.py:88-123. Neither is available here, so the
framework carries its own implementations: HPSS follows the classic Fitzgerald/Driedger
median-filtering formulation with soft masks and margins (librosa-equivalent semantics), and
the stretch is a standard phase vocoder. These feed random augmentation, so bit-exactness with
the upstream libraries is not required; tests pin shapes, bounds and the separation property.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import median_filter


def _hann(n: int) -> np.ndarray:
    return np.hanning(n + 1)[:-1]


def stft(x: np.ndarray, n_fft: int, hop: int, win_length: int | None = None) -> np.ndarray:
    """Centred reflect-padded complex STFT ``[n_fft//2+1, frames]``.

    Deliberately 1-D: a batched [C, T] variant was measured ~35% *slower* end-to-end on
    this class of host (single-CPU; the 6x-larger f64/complex intermediates fall out of
    cache) — multichannel callers should loop rows."""
    win_length = win_length or n_fft
    window = _hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    pad = n_fft // 2
    x = np.pad(np.asarray(x, dtype=np.float64), (pad, pad), mode="reflect")
    # Enough frames to cover the signal *end* as well, so the ISTFT round-trip is lossless.
    n_frames = 1 + -(-(len(x) - n_fft) // hop)
    extra = (n_frames - 1) * hop + n_fft - len(x)
    if extra > 0:
        x = np.pad(x, (0, extra))
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(x[idx] * window[None, :], axis=1).T


def istft(S: np.ndarray, n_fft: int, hop: int, length: int | None = None,
          win_length: int | None = None) -> np.ndarray:
    """Inverse STFT by windowed overlap-add with squared-window normalisation."""
    win_length = win_length or n_fft
    window = _hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    frames = np.fft.irfft(S.T, n=n_fft, axis=1) * window[None, :]
    n_frames = frames.shape[0]
    total = n_fft + hop * (n_frames - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    w2 = window ** 2
    for t in range(n_frames):
        out[t * hop: t * hop + n_fft] += frames[t]
        norm[t * hop: t * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-10)
    pad = n_fft // 2
    out = out[pad: total - pad]
    if length is not None:
        if len(out) < length:
            out = np.pad(out, (0, length - len(out)))
        out = out[:length]
    return out


def _soft_mask(x: np.ndarray, ref: np.ndarray, power: float = 2.0) -> np.ndarray:
    z = np.maximum(np.maximum(x, ref), 1e-30)
    xp = (x / z) ** power
    rp = (ref / z) ** power
    return xp / (xp + rp)


def hpss_masks(mag: np.ndarray, kernel_size=(31, 31), margin=(1.0, 1.0),
               power: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """Harmonic / percussive soft masks from median-filtered magnitudes ``[freq, time]``."""
    kh, kp = kernel_size if np.iterable(kernel_size) else (kernel_size, kernel_size)
    mh, mp = margin if np.iterable(margin) else (margin, margin)
    harm_ref = median_filter(mag, size=(1, int(kh)), mode="reflect")   # smooth along time
    perc_ref = median_filter(mag, size=(int(kp), 1), mode="reflect")   # smooth along freq
    mask_h = _soft_mask(harm_ref, perc_ref * mh, power)
    mask_p = _soft_mask(perc_ref, harm_ref * mp, power)
    return mask_h, mask_p


def hpss_split(x: np.ndarray, n_fft: int, hop: int, margin, kernel) \
        -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decompose into (harmonic, percussive, residual) waveforms of equal length."""
    S = stft(x, n_fft, hop)
    mask_h, mask_p = hpss_masks(np.abs(S), kernel_size=kernel, margin=margin)
    harm, perc = S * mask_h, S * mask_p
    resid = S - (harm + perc)
    n = len(x)
    return (istft(harm, n_fft, hop, n), istft(perc, n_fft, hop, n), istft(resid, n_fft, hop, n))


def _nearest_peak_index(mag: np.ndarray) -> np.ndarray:
    """Per column: index of the nearest local spectral maximum for every bin.

    A bin is a peak when it is >= both neighbours (plateau-tolerant). Bins with no peak
    in their column (silence) map to themselves.
    """
    n_bins, k = mag.shape
    peak = np.zeros_like(mag, dtype=bool)
    peak[1:-1] = (mag[1:-1] >= mag[:-2]) & (mag[1:-1] >= mag[2:]) & (mag[1:-1] > 0)
    rows = np.arange(n_bins)[:, None]
    # Nearest peak at-or-below / at-or-above each bin, per column.
    below = np.maximum.accumulate(np.where(peak, rows, -1), axis=0)
    above = np.flip(np.minimum.accumulate(
        np.flip(np.where(peak, rows, n_bins), axis=0), axis=0), axis=0)
    d_below = np.where(below >= 0, rows - below, n_bins)
    d_above = np.where(above < n_bins, above - rows, n_bins)
    idx = np.where(d_below <= d_above, below, above)
    return np.where((idx < 0) | (idx >= n_bins), rows, idx)


def time_stretch(x: np.ndarray, fs: int, rate: float, keep_length: bool = False) -> np.ndarray:
    """Phase-vocoder time stretch with identity phase locking; ``rate > 1`` shortens
    (librosa convention).

    The classic free-running per-bin accumulator (librosa ``phase_vocoder``) lets the
    inter-bin phase relationships inside each spectral peak's mainlobe drift apart —
    measured here as a uniform ~0.46x amplitude loss on a pure tone for every rate < 1
    (the bins of the mainlobe end up partially cancelling in the overlap-add; see
    tests/test_dsp_invariants.py). Since this module replaces *pyrubberband* (reference
    src/mpcg_wav2vec/augment/primitives.py:30-44), not librosa, quality parity argues for
    the textbook fix: Laroche-Dolson identity phase locking — only each region's peak bin
    accumulates phase; every other bin copies its phase offset *relative to that peak*
    from the input frame, keeping mainlobe structure intact. Tone RMS under stretch is
    then preserved for all rates (pinned by the invariant tests).
    """
    if rate == 1.0 or len(x) < 64:
        return np.asarray(x, dtype=np.float64).copy()
    n_fft = 2048 if len(x) >= 2048 else 1 << max(6, int(np.ceil(np.log2(len(x)))) - 1)
    hop = n_fft // 4
    S = stft(x, n_fft, hop)
    n_bins, n_frames = S.shape

    steps = np.arange(0, n_frames, rate)
    omega = (2 * np.pi * hop * np.arange(n_bins) / n_fft)[:, None]   # phase advance/frame
    mag_pad = np.pad(np.abs(S), [(0, 0), (0, 2)])
    ang = np.angle(np.pad(S, [(0, 0), (0, 2)]))

    # Free-running per-bin accumulation as one gather + cumsum (the classic loop is a
    # disguised prefix sum over input-frame pairs).
    j = steps.astype(np.int64)
    frac = steps - j
    mag = (1 - frac) * mag_pad[:, j] + frac * mag_pad[:, j + 1]
    dphi = ang[:, j + 1] - ang[:, j] - omega
    dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
    incr = np.cumsum(omega + dphi, axis=1)
    acc = np.angle(S[:, 0])[:, None] + np.concatenate(
        [np.zeros((n_bins, 1)), incr[:, :-1]], axis=1)

    # Identity phase locking: every bin takes its region peak's accumulated phase plus
    # its own input-frame offset from that peak.
    cols = np.arange(len(j))[None, :]
    pk = _nearest_peak_index(mag)
    phase = acc[pk, cols] + ang[:, j] - ang[pk, j[None, :]]
    out = mag * np.exp(1j * phase)

    y = istft(out, n_fft, hop, length=int(round(len(x) / rate)))
    if keep_length:
        y = y[: len(x)]
    return y
