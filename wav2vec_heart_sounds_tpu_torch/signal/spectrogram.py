"""Mel-spectrogram oracle (NumPy) used as diffusion conditioning.

Reproduces the exact semantics the reference gets from ``torchaudio.transforms.MelSpectrogram``
(reference src/mpcg_wav2vec/signalproc/spectrogram.py:13-54): centred reflect-padded STFT with a
periodic Hann window, window-energy normalisation, magnitude (power=1), and an HTK-scale
triangular mel filterbank with no area norm. ``f_max`` distinguishes PCG (500 Hz) from ECG
(200 Hz) conditioning.

The device twin lives in :mod:`..ops.stft`; both paths share :func:`mel_filterbank`.

A copy of ``wav2vec_heart_sounds_tpu/signal/spectrogram.py``, held to the original by
``tests/test_torch_imports.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """``[n_freqs, n_mels]`` HTK triangular filterbank (torchaudio ``melscale_fbanks`` semantics)."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)                                    # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]               # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def stft_magnitude(x: np.ndarray, n_fft: int, hop_length: int, win_length: int,
                   *, normalized: bool = True) -> np.ndarray:
    """Centred reflect-padded magnitude STFT ``[n_fft//2+1, frames]`` of a 1-D signal."""
    x = np.asarray(x, dtype=np.float64)
    window = np.hanning(win_length + 1)[:-1]                   # periodic Hann
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (x.size - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx] * window[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)).T      # [freq, frames]
    if normalized:
        spec = spec / np.sqrt(np.sum(window ** 2))
    return spec


@dataclass(frozen=True)
class MelConfig:
    """Conditioning mel-spectrogram parameters (f_max: PCG 500 Hz vs ECG 200 Hz)."""
    sample_rate: int
    n_fft: int
    hop_length: int
    win_length: int | None = None
    n_mels: int = 80
    f_min: float = 0.125
    f_max: float = 500.0

    @property
    def win(self) -> int:
        return self.win_length or self.n_fft

    def filterbank(self) -> np.ndarray:
        return mel_filterbank(self.n_fft // 2 + 1, self.f_min, self.f_max,
                              self.n_mels, self.sample_rate)


def mel_spectrogram(x: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """``[n_mels, frames]`` magnitude mel-spectrogram."""
    spec = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win)
    return cfg.filterbank().T @ spec


def log_mel(x: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Mel in dB, shifted/scaled into [0, 1] (the diffusion conditioner's dynamic range)."""
    mel = mel_spectrogram(x, cfg)
    mel = 20.0 * np.log10(np.maximum(mel, 1e-5)) - 20.0
    return np.clip((mel + 100.0) / 100.0, 0.0, 1.0)


def add_chirp(x: np.ndarray, fs: float) -> np.ndarray:
    """Superimpose a full-band linear chirp (spectral-reference diagnostic)."""
    from scipy.signal import chirp

    t = np.arange(len(x)) / fs
    wave = np.asarray(chirp(t, f0=0, f1=fs / 2, t1=t[-1] if len(t) else 1.0, method="linear"))
    peak = np.max(np.abs(wave)) or 1.0
    target = max(0.5, float(np.max(np.abs(x))) if len(x) else 0.5)
    return x + wave / peak * target
