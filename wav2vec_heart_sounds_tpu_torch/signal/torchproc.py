"""Batched PyTorch preprocessing: whole batches from raw waveform to encoder input.

Port of ``wav2vec_heart_sounds_tpu/signal/jaxproc.py``'s two chains with the same stage
orders: PCG resample -> despike -> 450 Hz low-pass -> 25 Hz high-pass -> abs-max; ECG
resample -> 40 Hz low-pass -> 2 Hz high-pass -> abs-max. Each runs on the device of its
input, in float32. The batched normalisers and the window segmentation that ``jaxproc``
re-exports are :mod:`..ops.normalize` and :mod:`..ops.segment`.
"""

from __future__ import annotations

import torch

from ..config import ECG_BAND, PCG_BAND
from ..ops.despike import remove_spikes
from ..ops.iir import bandpass_cascade
from ..ops.normalize import abs_max_normalise
from ..ops.resample import resample


def preprocess_pcg(x: torch.Tensor, fs_in: float, fs_out: float) -> torch.Tensor:
    """PCG chain on ``[B, T]`` (or ``[T]``): resample -> despike -> 25-450 Hz -> abs-max."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    x = remove_spikes(resample(x, fs_in, fs_out), fs_out)
    x = bandpass_cascade(x, fs_out, *PCG_BAND, order=2)
    x = abs_max_normalise(x)
    return x[0] if squeeze else x


def preprocess_ecg(x: torch.Tensor, fs_in: float, fs_out: float) -> torch.Tensor:
    """ECG chain on ``[B, T]`` (or ``[T]``): resample -> 2-40 Hz -> abs-max."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    x = bandpass_cascade(resample(x, fs_in, fs_out), fs_out, *ECG_BAND, order=2)
    x = abs_max_normalise(x)
    return x[0] if squeeze else x
