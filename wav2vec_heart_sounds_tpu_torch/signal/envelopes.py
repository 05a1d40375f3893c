"""Copy of ``wav2vec_heart_sounds_tpu/signal/envelopes.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Envelope extraction oracle (Hilbert / homomorphic).

Contract from reference src/mpcg_wav2vec/signalproc/envelopes.py:11-23.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

from .filters import butter_lowpass


def hilbert_envelope(x: np.ndarray) -> np.ndarray:
    return np.abs(sps.hilbert(np.asarray(x, dtype=np.float64)))


def homomorphic_envelope(x: np.ndarray, fs: float, cutoff: float = 8.0, order: int = 6) -> np.ndarray:
    """Exponentiated low-passed log-envelope (classic homomorphic envelogram)."""
    if cutoff >= 0.5 * fs:
        raise ValueError(f"cutoff {cutoff} Hz is above Nyquist for fs={fs}")
    env = np.maximum(hilbert_envelope(x), np.finfo(float).eps)
    return np.exp(butter_lowpass(np.log(env), fs, cutoff, order=order))
