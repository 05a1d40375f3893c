"""Copy of ``wav2vec_heart_sounds_tpu/signal/resample.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Rational polyphase resampling oracle.

Contract from reference src/mpcg_wav2vec/signalproc/resample.py:11-22: reduce the up/down
factors by their GCD and run SciPy's polyphase resampler. The device twin applies the very same
host-designed FIR via a dilated/strided convolution (:mod:`..ops.resample`).
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy import signal as sps


def resample_factors(fs_in: float, fs_out: float) -> tuple[int, int]:
    up, down = int(round(fs_out)), int(round(fs_in))
    g = gcd(up, down)
    return up // g, down // g


def resample(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    if fs_in == fs_out:
        return np.asarray(x)
    up, down = resample_factors(fs_in, fs_out)
    return sps.resample_poly(x, up, down)
