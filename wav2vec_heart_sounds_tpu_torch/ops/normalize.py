"""Batched amplitude normalisers (port of ``wav2vec_heart_sounds_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def abs_max_normalise(x: torch.Tensor) -> torch.Tensor:
    """Zero-mean, peak-normalise and clip each row of ``[..., T]`` (NaNs become 0)."""
    x = torch.nan_to_num(x)
    x = x - x.mean(dim=-1, keepdim=True)
    peak = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return (x / peak).clamp(-1.0, 1.0)


def fit_length(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad or crop the trailing axis to exactly ``length`` samples."""
    T = x.shape[-1]
    if T < length:
        return F.pad(x, (0, length - T))
    return x[..., :length]
