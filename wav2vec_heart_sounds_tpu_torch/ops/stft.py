"""Batched STFT / mel-spectrogram on device tensors (port of ``ops/stft.py``; the twin of
:mod:`..signal.spectrogram`).

Reflect pad, frames as a strided view (``unfold``), ``torch.fft.rfft``, and the mel
projection as one ``[freq, mel]`` matmul. The window (periodic Hann, zero-padded to
``n_fft`` about its centre) and the HTK filterbank are built on the host exactly as the
JAX module builds them (shared :func:`..signal.spectrogram.mel_filterbank`) and moved to the
input's device and dtype.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..signal.spectrogram import MelConfig, mel_filterbank


@lru_cache(maxsize=None)
def _window_and_fbank(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    win = np.hanning(cfg.win + 1)[:-1]
    if cfg.win < cfg.n_fft:
        lpad = (cfg.n_fft - cfg.win) // 2
        win = np.pad(win, (lpad, cfg.n_fft - cfg.win - lpad))
    fbank = mel_filterbank(cfg.n_fft // 2 + 1, cfg.f_min, cfg.f_max, cfg.n_mels, cfg.sample_rate)
    return win.astype(np.float32), fbank.astype(np.float32)


def stft_magnitude(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``[..., T]`` -> ``[..., n_fft//2+1, frames]`` centred, window-normalised magnitude."""
    window, _ = _window_and_fbank(cfg)
    window = torch.as_tensor(window, dtype=x.dtype, device=x.device)
    pad = cfg.n_fft // 2
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    flat = F.pad(flat, (pad, pad), mode="reflect")[:, 0]
    frames = flat.unfold(-1, cfg.n_fft, cfg.hop_length) * window       # [N, frames, n_fft]
    spec = torch.fft.rfft(frames, dim=-1).abs()
    spec = spec / torch.sqrt(torch.sum(window ** 2))
    return spec.transpose(-1, -2).reshape(*lead, spec.shape[-1], spec.shape[-2])


def mel_spectrogram(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """``[..., T]`` -> ``[..., n_mels, frames]``."""
    _, fbank = _window_and_fbank(cfg)
    spec = stft_magnitude(x, cfg)
    fbank = torch.as_tensor(fbank, dtype=spec.dtype, device=spec.device)
    return torch.einsum("fm,...ft->...mt", fbank, spec)


def log_mel(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Mel in dB mapped into [0, 1] (diffusion-conditioner dynamic range)."""
    mel = mel_spectrogram(x, cfg)
    mel = 20.0 * torch.log10(torch.clamp(mel, min=1e-5)) - 20.0
    return torch.clamp((mel + 100.0) / 100.0, 0.0, 1.0)
