"""Copy of ``wav2vec_heart_sounds_tpu/signal/segment.py`` (numpy only), held to the original
by ``tests/test_torch_imports.py``; the window itself is :class:`..config.WindowSpec`.

Overlapping fixed-length window segmentation.

Behavioral contract from reference src/mpcg_wav2vec/signalproc/segment.py:17-52: windows of
``window_s`` seconds with ``overlap_s`` overlap, the first ``start_pad_s`` seconds of every
recording discarded, the final window clamped to the signal end and zero-padded to full length.
"""

from __future__ import annotations

import numpy as np

from ..config import WindowSpec


def window_starts(n_samples: int, fs: float, spec: WindowSpec) -> list[int]:
    """Start indices of each window; empty when the signal ends inside the start pad."""
    first = spec.start_offset(fs)
    if n_samples <= first:
        return []
    last = max(first, n_samples - spec.window_len(fs))
    starts = list(range(first, last + 1, spec.hop_len(fs)))
    return starts or [first]


def pad_or_crop(array: np.ndarray, length: int) -> tuple[np.ndarray, int]:
    """Zero-pad or crop along axis 0 to exactly ``length``; returns (array, valid_samples)."""
    n = array.shape[0]
    if n < length:
        widths = [(0, length - n)] + [(0, 0)] * (array.ndim - 1)
        array = np.pad(array, widths)
    elif n > length:
        array = array[:length]
    return array, min(n, length)


def segment(signal: np.ndarray, fs: float, spec: WindowSpec) -> np.ndarray:
    """Window ``[T]`` / ``[T, C]`` into ``[N, win]`` / ``[N, win, C]``."""
    signal = np.asarray(signal)
    win = spec.window_len(fs)
    starts = window_starts(signal.shape[0], fs, spec)
    if not starts:
        shape = (0, win) if signal.ndim == 1 else (0, win, signal.shape[1])
        return np.zeros(shape, dtype=signal.dtype)
    chunks = [pad_or_crop(signal[s:s + win], win)[0] for s in starts]
    return np.stack(chunks, axis=0)
