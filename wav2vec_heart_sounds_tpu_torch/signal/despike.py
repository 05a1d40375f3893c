"""Copy of ``wav2vec_heart_sounds_tpu/signal/despike.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Schmidt spike removal oracle (Schmidt et al. 2010).

Behavioral contract from reference src/mpcg_wav2vec/signalproc/despike.py:16-54: analyse the
signal in 500 ms windows; while any window's max absolute amplitude (MAA) exceeds
``threshold`` x the median MAA, take the single worst window, find the spike peak, and flatten
the samples between the zero-crossings surrounding the peak to a small floor value.

The device twin (:mod:`..ops.despike`) re-expresses the same loop as a batched, fixed-shape
``lax.while_loop`` and is pinned against this oracle by the equivalence tests.
"""

from __future__ import annotations

import numpy as np

SPIKE_FLOOR = 1e-4


def spike_bounds(window: np.ndarray, peak: int) -> tuple[int, int]:
    """[start, end) range to flatten around ``peak``: between surrounding sign flips."""
    signs = np.sign(window)
    flips = np.where(np.abs(np.diff(signs)) > 1)[0]
    before = flips[flips < peak]
    after = flips[flips >= peak]
    start = int(before[-1]) + 1 if before.size else 0
    end = int(after[0]) if after.size else window.size - 1
    return start, end


def remove_spikes(signal: np.ndarray, fs: float, threshold: float = 3.0,
                  max_iterations: int = 1000) -> np.ndarray:
    signal = np.asarray(signal, dtype=np.float64).copy()
    win = round(float(fs) / 2.0)
    if win < 1 or signal.size < win:
        return signal

    usable = signal.size - signal.size % win
    frames = signal[:usable].reshape(-1, win)  # row w = samples [w*win, (w+1)*win)

    for _ in range(max_iterations):
        maa = np.max(np.abs(frames), axis=1)
        med = np.median(maa)
        if med == 0 or np.all(maa <= threshold * med):
            break
        w = int(np.argmax(maa))
        peak = int(np.argmax(np.abs(frames[w])))
        start, end = spike_bounds(frames[w], peak)
        frames[w, start:end] = SPIKE_FLOOR

    signal[:usable] = frames.reshape(-1)
    return signal
