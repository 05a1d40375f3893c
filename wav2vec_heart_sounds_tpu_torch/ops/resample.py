"""Polyphase rational resampling as one zero-stuffed strided convolution.

Port of ``wav2vec_heart_sounds_tpu/ops/resample.py``. The FIR is scipy's ``resample_poly``
design, made once on the host in float64. ``torch.conv1d`` has no input dilation (JAX's
``lhs_dilation=up``), so the zeros are stuffed explicitly: the input is scattered into
every ``up``-th slot of a zero tensor, then one correlation with the flipped filter at
stride ``down`` filters and decimates. The padding keeps scipy's group-delay centring:
output ``i`` sits at full-convolution index ``half_len + i * down``.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin

from . import full_fp32


@lru_cache(maxsize=None)
def polyphase_filter(up: int, down: int) -> np.ndarray:
    """The exact FIR scipy's resample_poly designs: kaiser(5.0), cutoff 1/max_rate, gain up."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float64)


def resample_factors(fs_in: float, fs_out: float) -> tuple[int, int]:
    up, down = int(round(fs_out)), int(round(fs_in))
    g = gcd(up, down)
    return up // g, down // g


def resample(x: torch.Tensor, fs_in: float, fs_out: float) -> torch.Tensor:
    """Resample ``[..., T]`` from ``fs_in`` to ``fs_out`` (scipy resample_poly semantics)."""
    if fs_in == fs_out:
        return x
    up, down = resample_factors(fs_in, fs_out)
    h = polyphase_filter(up, down)
    half_len = (len(h) - 1) // 2

    T = x.shape[-1]
    n_out = -(-T * up // down)                      # ceil
    stuffed_len = (T - 1) * up + 1
    pad_l = half_len
    pad_r = max(0, (n_out - 1) * down + len(h) - 1 - pad_l - stuffed_len + 1)

    lead = x.shape[:-1]
    rows = x.reshape(-1, T)
    stuffed = rows.new_zeros((rows.shape[0], 1, stuffed_len))
    stuffed[:, 0, ::up] = rows
    weight = torch.as_tensor(h[::-1].copy(), dtype=x.dtype, device=x.device).view(1, 1, -1)
    with full_fp32():
        out = F.conv1d(F.pad(stuffed, (pad_l, pad_r)), weight, stride=down)
    return out[:, 0, :n_out].reshape(lead + (n_out,))
