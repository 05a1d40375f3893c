"""Copy of ``wav2vec_heart_sounds_tpu/signal/preprocess.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

High-level PCG / ECG preprocessing chains (oracle).

Contract from reference src/mpcg_wav2vec/signalproc/preprocess.py:19-64:

* PCG: NaN-interp -> resample -> Schmidt despike -> 25-450 Hz causal cascade -> abs-max
* ECG: NaN-interp -> resample -> 2-40 Hz causal cascade -> abs-max
"""

from __future__ import annotations

import numpy as np

from .despike import remove_spikes
from .filters import ECG_BAND, PCG_BAND, bandpass_cascade, decompose_bands
from .normalize import abs_max_normalise, interpolate_nans
from .resample import resample
from .segment import pad_or_crop as fit_length  # shared pad/crop helper


def preprocess_pcg(pcg: np.ndarray, fs_in: float, fs_out: float, *, despike: bool = True) -> np.ndarray:
    x = interpolate_nans(pcg)
    x = resample(x, fs_in, fs_out)
    if despike:
        x = remove_spikes(x, fs_out)
    x = bandpass_cascade(x, fs_out, *PCG_BAND, order=2)
    return abs_max_normalise(x)


def preprocess_ecg(ecg: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    x = interpolate_nans(ecg)
    x = resample(x, fs_in, fs_out)
    x = bandpass_cascade(x, fs_out, *ECG_BAND, order=2)
    return abs_max_normalise(x)


def preprocess_four_bands(pcg: np.ndarray, fs: float) -> np.ndarray:
    """``[T, 4]`` zero-phase FIR band decomposition of a PCG signal."""
    return decompose_bands(np.asarray(pcg).squeeze(), fs).T
