"""Copy of ``wav2vec_heart_sounds_tpu/augment/noise_sources.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Recorded clinical-noise sources for augmentation.

Contract from reference src/mpcg_wav2vec/augment/noise_sources.py:23-64: PCG noise from the
EPHNOGRAM auxiliary channels (AUX1/AUX2), ECG noise from the MIT-BIH Noise Stress Test records
(``em``/``bw``/``ma``), read at a random offset, resampled to the target rate, randomly scaled
(possibly to zero), and cropped. Unreadable records degrade to silence instead of crashing a
training run. Records are read with the framework's own WFDB reader (:mod:`..data.wfdb_io`).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from scipy import signal as sps

from ..signal.normalize import abs_max_normalise
from .primitives import default_rng, random_crop


def _read_random_window(path: str, rng: np.random.Generator, max_seconds: float = -1.0):
    # Imported lazily: data.* imports augment.* for its pipelines, so a top-level import
    # here would be circular.
    from ..data import wfdb_io

    header = wfdb_io.read_header(path)
    total = header.sig_len
    want = total if max_seconds <= -1.0 else round(max_seconds * header.fs)
    if total > want:
        start = int(rng.integers(0, total - want + 1))
        return wfdb_io.read_record(path, sampfrom=start, sampto=start + want)
    return wfdb_io.read_record(path)


def pcg_noise(fs: float, length: int, ephnogram_dir: str,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Random EPHNOGRAM AUX-channel noise, scaled down and cropped to ``length`` samples."""
    rng = default_rng(rng)
    files = glob.glob(os.path.join(ephnogram_dir, "*.hea"))
    for _ in range(50):
        if not files:
            break
        try:
            rec = _read_random_window(rng.choice(files).removesuffix(".hea"), rng)
            names = rec.sig_name
            parts = []
            for aux in ("AUX1", "AUX2"):
                sig = rec.p_signal[:, names.index(aux)]
                sig = sps.resample_poly(np.nan_to_num(sig), int(fs), int(rec.fs))
                scale = float(rng.choice([0.0, rng.uniform(0.0, 0.05)]))
                parts.append(scale * abs_max_normalise(random_crop(sig, length, rng)))
            combined = parts[0] + parts[1]
            if np.max(np.abs(combined)) > 0:
                combined = abs_max_normalise(combined)
            return combined
        except (ValueError, IndexError, OSError):
            continue
    return np.zeros(length)


def pcg_noise_bank(fs: float, length: int, ephnogram_dir: str, k: int = 64,
                   rng: np.random.Generator | None = None) -> np.ndarray | None:
    """Pre-cut ``[k, length]`` bank of recorded-noise snippets for on-device mixing.

    Built once at wiring time and shipped to the device, so the recorded-noise stage of
    the vest pipeline can run *after* the on-device wander/noise stages in reference
    order (``jaxaug.augment_multi_pcg_batch``) instead of on the host before them.
    Returns ``None`` when the directory yields no usable noise (callers then keep the
    host fallback)."""
    rng = default_rng(rng)
    bank = np.stack([pcg_noise(fs, length, ephnogram_dir, rng) for _ in range(k)])
    if not np.any(np.abs(bank) > 0):
        return None
    return bank.astype(np.float32)


def ecg_noise(fs: float, length: int, mit_dir: str,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Sum of randomly scaled MIT-BIH em/bw/ma noise, cropped to ``length`` samples."""
    rng = default_rng(rng)
    try:
        parts = []
        for name, (lo, hi) in {"em": (0.0, 0.25), "bw": (0.0, 0.5), "ma": (0.0, 0.25)}.items():
            rec = _read_random_window(os.path.join(mit_dir, name), rng)
            sig = sps.resample_poly(np.nan_to_num(rec.p_signal[:, 0]), int(fs), int(rec.fs))
            scale = float(rng.choice([0.0, rng.uniform(lo, hi)]))
            parts.append(scale * abs_max_normalise(random_crop(sig, length, rng)))
        return sum(parts)
    except (FileNotFoundError, ValueError, IndexError, OSError):
        return np.zeros(length)
