"""Batched overlapping window extraction (port of ``wav2vec_heart_sounds_tpu/ops/segment.py``,
the device twin of :mod:`..signal.segment`).

Drop the start pad, zero-pad up to one window, then take hop-strided windows: the JAX
module's static gather is ``Tensor.unfold`` here, which returns a strided view of the
padded input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import WindowSpec


def segment(x: torch.Tensor, fs: float, spec: WindowSpec) -> torch.Tensor:
    """``[B, T]`` -> ``[B, N, win]`` overlapping windows (also accepts ``[T]`` -> ``[N, win]``)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    win = spec.window_len(fs)
    x = x[:, spec.start_offset(fs):]
    if x.shape[-1] < win:
        x = F.pad(x, (0, win - x.shape[-1]))
    out = x.unfold(-1, win, spec.hop_len(fs))
    return out[0] if squeeze else out
