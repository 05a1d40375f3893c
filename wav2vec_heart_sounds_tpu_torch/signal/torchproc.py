"""Batched PyTorch preprocessing: whole batches from raw waveform to encoder input.

Port of ``wav2vec_heart_sounds_tpu/signal/jaxproc.py::preprocess_pcg`` with the same stage
order: resample -> despike -> 450 Hz low-pass -> 25 Hz high-pass -> abs-max. Runs on the
device of its input, in float32.
"""

from __future__ import annotations

import torch

from ..config import PCG_BAND
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
