"""ctypes bindings for the native host-side preprocessing library (``native/fastproc.cpp``):
port of ``wav2vec_heart_sounds_tpu/native.py``, building the same C++ source.

Builds the shared library on first use (g++ -O3 -fopenmp) into ``build/native/`` of the
checkout and exposes NumPy-friendly wrappers. Numerics match the Python oracle to ~1e-10;
the batch entry point parallelises across records with OpenMP — the fast path for dataset
builders (the reference's load-time preprocessing was single-threaded Python, SURVEY.md §3
hot-loop 5).

``available()`` gates usage: anything that can fail (no compiler, exotic platform) degrades
to the NumPy oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from math import gcd

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "fastproc.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


@lru_cache(maxsize=1)
def _load():
    # The library is never committed (binaries are host-specific and unreviewable);
    # it is rebuilt from source, keyed on the source content hash so edits — not
    # mtimes, which a fresh checkout resets — trigger recompilation. Portable arch
    # flags: the build host's ISA extensions must not leak into the artifact.
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        lib_path = os.path.join(BUILD_DIR, f"libfastproc-{digest}.so")
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
        lib = ctypes.CDLL(lib_path)
    except Exception:
        return None

    lib.resample_poly_f64.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                      _f64p, ctypes.c_int64, _f64p, ctypes.c_int64]
    lib.sosfilt_f64.argtypes = [_f64p, ctypes.c_int, _f64p, ctypes.c_int64]
    lib.despike_f64.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                                ctypes.c_int]
    lib.abs_max_normalise_f64.argtypes = [_f64p, ctypes.c_int64]
    lib.interpolate_nans_f64.argtypes = [_f64p, ctypes.c_int64]
    chain_args = [_f64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _f64p, ctypes.c_int64,
                  _f64p, _f64p, ctypes.c_int, ctypes.c_int64, _f64p, ctypes.c_int64]
    lib.preprocess_chain_f64.argtypes = chain_args
    lib.preprocess_batch_f64.argtypes = chain_args[:1] + [ctypes.c_int64] + chain_args[1:]
    return lib


def available() -> bool:
    return _load() is not None


def _resample_plan(fs_in: float, fs_out: float):
    from .ops.resample import polyphase_filter

    up, down = int(round(fs_out)), int(round(fs_in))
    g = gcd(up, down)
    up, down = up // g, down // g
    h = polyphase_filter(up, down) if up != down else np.zeros(1)
    return up, down, np.ascontiguousarray(h)


@lru_cache(maxsize=None)
def _band_sos(fs: float, low: float, high: float):
    from scipy import signal as sps

    lp = np.ascontiguousarray(
        sps.butter(2, high / fs, btype="lowpass", output="sos")[0], dtype=np.float64)
    hp = np.ascontiguousarray(
        sps.butter(2, low / fs, btype="highpass", output="sos")[0], dtype=np.float64)
    return lp, hp


def resample(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    lib = _load()
    if lib is None:
        from .signal.resample import resample as oracle
        return oracle(np.asarray(x, dtype=np.float64), fs_in, fs_out)
    x = np.ascontiguousarray(x, dtype=np.float64)
    if fs_in == fs_out:
        return x
    up, down, h = _resample_plan(fs_in, fs_out)
    n_out = -(-len(x) * up // down)
    out = np.empty(n_out)
    lib.resample_poly_f64(x, len(x), up, down, h, len(h), out, n_out)
    return out


def remove_spikes(x: np.ndarray, fs: float, threshold: float = 3.0,
                  max_iterations: int = 1000) -> np.ndarray:
    lib = _load()
    if lib is None:
        from .signal.despike import remove_spikes as oracle
        return oracle(np.asarray(x, dtype=np.float64), fs, threshold, max_iterations)
    x = np.ascontiguousarray(x, dtype=np.float64).copy()
    lib.despike_f64(x, len(x), round(float(fs) / 2.0), threshold, max_iterations)
    return x


def _preprocess(x: np.ndarray, fs_in: float, fs_out: float, band: tuple[float, float],
                despike: bool) -> np.ndarray:
    lib = _load()
    if lib is None:
        from .signal import preprocess as sp
        x = np.asarray(x, dtype=np.float64)
        if band == (2.0, 40.0):
            return sp.preprocess_ecg(x, fs_in, fs_out)
        return sp.preprocess_pcg(x, fs_in, fs_out, despike=despike)
    x = np.ascontiguousarray(x, dtype=np.float64)
    up, down, h = _resample_plan(fs_in, fs_out)
    n_out = -(-len(x) * up // down) if up != down else len(x)
    lp, hp = _band_sos(fs_out, *band)
    out = np.empty(n_out)
    lib.preprocess_chain_f64(x, len(x), up, down, h, len(h), lp, hp,
                             int(despike), round(float(fs_out) / 2.0), out, n_out)
    return out


def preprocess_pcg(x: np.ndarray, fs_in: float, fs_out: float, *,
                   despike: bool = True) -> np.ndarray:
    return _preprocess(x, fs_in, fs_out, (25.0, 450.0), despike)


def preprocess_ecg(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    return _preprocess(x, fs_in, fs_out, (2.0, 40.0), False)


def preprocess_pcg_batch(x: np.ndarray, fs_in: float, fs_out: float, *,
                         despike: bool = True) -> np.ndarray:
    """OpenMP-parallel PCG chain over a [B, T] batch of equal-length records."""
    lib = _load()
    if lib is None:
        return np.stack([_preprocess(row, fs_in, fs_out, (25.0, 450.0), despike)
                         for row in np.asarray(x, dtype=np.float64)])
    x = np.ascontiguousarray(x, dtype=np.float64)
    batch, n = x.shape
    up, down, h = _resample_plan(fs_in, fs_out)
    n_out = -(-n * up // down) if up != down else n
    lp, hp = _band_sos(fs_out, 25.0, 450.0)
    out = np.empty((batch, n_out))
    lib.preprocess_batch_f64(x, batch, n, up, down, h, len(h), lp, hp,
                             int(despike), round(float(fs_out) / 2.0), out, n_out)
    return out
