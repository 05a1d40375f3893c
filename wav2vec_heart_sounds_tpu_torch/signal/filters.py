"""Copy of ``wav2vec_heart_sounds_tpu/signal/filters.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

IIR / FIR filter oracle (NumPy + SciPy).

Two cutoff conventions coexist, matching reference src/mpcg_wav2vec/signalproc/filters.py:25-98:

* the *causal* preprocessing band filters normalise the cutoff by the **sampling rate** (the
  paper's convention — so the effective -3 dB point sits at cutoff/2 in true Hz terms), and
* the generic zero-phase helpers use the usual Nyquist normalisation.

Coefficient design always happens on the host in float64 via SciPy; the device twin
(:mod:`..ops.iir`) reuses exactly these coefficients.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

PCG_BAND = (25.0, 450.0)
ECG_BAND = (2.0, 40.0)


def butter_ba(cutoff: float, fs: float, btype: str, order: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Design the causal band-filter coefficients with the fs-normalised convention."""
    b, a = sps.butter(order, cutoff / fs, btype=btype)
    return np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64)


def lowpass(x: np.ndarray, fs: float, cutoff: float, order: int = 2) -> np.ndarray:
    sos = sps.butter(order, cutoff / fs, btype="lowpass", output="sos")
    return sps.sosfilt(sos, np.asarray(x, dtype=np.float64))


def highpass(x: np.ndarray, fs: float, cutoff: float, order: int = 2) -> np.ndarray:
    sos = sps.butter(order, cutoff / fs, btype="highpass", output="sos")
    return sps.sosfilt(sos, np.asarray(x, dtype=np.float64))


def bandpass_cascade(x: np.ndarray, fs: float, low: float, high: float, order: int = 2) -> np.ndarray:
    """The PCG/ECG preprocessing band: causal LP at the high edge, then HP at the low edge."""
    return highpass(lowpass(x, fs, high, order=order), fs, low, order=order)


# --- zero-phase helpers (Nyquist-normalised), for envelopes / band decomposition -----------

def _zp(x: np.ndarray, sos: np.ndarray) -> np.ndarray:
    return sps.sosfiltfilt(sos, np.asarray(x, dtype=np.float64))


def butter_bandpass(x: np.ndarray, fs: float, low: float, high: float, order: int = 4) -> np.ndarray:
    nyq = 0.5 * fs
    return _zp(x, sps.butter(order, [low / nyq, high / nyq], btype="bandpass", output="sos"))


def butter_lowpass(x: np.ndarray, fs: float, cutoff: float, order: int = 4) -> np.ndarray:
    return _zp(x, sps.butter(order, cutoff / (0.5 * fs), btype="lowpass", output="sos"))


def butter_highpass(x: np.ndarray, fs: float, cutoff: float, order: int = 4) -> np.ndarray:
    return _zp(x, sps.butter(order, cutoff / (0.5 * fs), btype="highpass", output="sos"))


def band_stop(x: np.ndarray, fs: float, low: float, high: float, order: int = 4) -> np.ndarray:
    nyq = 0.5 * fs
    return _zp(x, sps.butter(order, [low / nyq, high / nyq], btype="bandstop", output="sos"))


def notch(x: np.ndarray, fs: float, freq: float, q: float = 30.0) -> np.ndarray:
    b, a = sps.iirnotch(freq / (0.5 * fs), q)
    return sps.filtfilt(b, a, np.asarray(x, dtype=np.float64))


def notch_chain(x: np.ndarray, fs: float, freqs, q: float = 55.0) -> np.ndarray:
    """Sequential notches for mains hum + harmonics; frequencies above Nyquist are skipped."""
    y = np.asarray(x, dtype=np.float64)
    for f in freqs:
        if f < 0.5 * fs:
            y = notch(y, fs, f, q)
    return y


def fir_subbands(fs: float, taps: int = 61, edges=(45.0, 80.0, 200.0)) -> list[np.ndarray]:
    """Four Hamming-window FIR bands (LP / BP / BP / HP) for the four-band PCG split."""
    nyq = 0.5 * fs
    e0, e1, e2 = edges
    return [
        sps.firwin(taps, e0 / nyq, window="hamming", pass_zero="lowpass"),
        sps.firwin(taps, [e0 / nyq, e1 / nyq], window="hamming", pass_zero="bandpass"),
        sps.firwin(taps, [e1 / nyq, e2 / nyq], window="hamming", pass_zero="bandpass"),
        sps.firwin(taps, e2 / nyq, window="hamming", pass_zero="highpass"),
    ]


def decompose_bands(x: np.ndarray, fs: float, **kwargs) -> np.ndarray:
    """``[num_bands, T]`` zero-phase FIR sub-band decomposition."""
    return np.stack(
        [sps.filtfilt(b, [1.0], np.asarray(x, dtype=np.float64)) for b in fir_subbands(fs, **kwargs)],
        axis=0,
    )
