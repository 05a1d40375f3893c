"""Batched amplitude normalisers (port of ``wav2vec_heart_sounds_tpu/ops/normalize.py``).

Reductions run along the trailing time axis, but :func:`kpeak_normalise`'s, which takes the
k largest and smallest entries of the whole array, as the original does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-8


def abs_max_normalise(x: torch.Tensor) -> torch.Tensor:
    """Zero-mean, peak-normalise and clip each row of ``[..., T]`` (NaNs become 0)."""
    x = torch.nan_to_num(x)
    x = x - x.mean(dim=-1, keepdim=True)
    peak = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return (x / peak).clamp(-1.0, 1.0)


def minmax_normalise(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    mn = x.amin(dim=-1, keepdim=True)
    span = x.amax(dim=-1, keepdim=True) - mn
    return (x - mn) / (span + EPS) * (hi - lo) + lo


def z_normalise(x: torch.Tensor) -> torch.Tensor:
    """Zero mean and unit (population) standard deviation per row."""
    mean = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mean) / (std + EPS)


def kpeak_normalise(x: torch.Tensor, k: int = 26, lo: float = -1.0,
                    hi: float = 1.0) -> torch.Tensor:
    """Rescale by the mean of the k largest / smallest entries of the whole array."""
    top = torch.sort(x.reshape(-1)).values
    hi_ref = top[-k:].mean()
    lo_ref = top[:k].mean()
    return lo + (x - lo_ref) / (hi_ref - lo_ref + EPS) * (hi - lo)


def fit_length(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad or crop the trailing axis to exactly ``length`` samples."""
    T = x.shape[-1]
    if T < length:
        return F.pad(x, (0, length - T))
    return x[..., :length]
