"""Copy of ``wav2vec_heart_sounds_tpu/data/wfdb_io.py`` (numpy and scipy only), held to the
original by ``tests/test_torch_imports.py``.

Minimal MIT/WFDB-format record I/O (reader + writer), dependency-free.

The reference reads PhysioNet records through the ``wfdb`` package (reference
src/mpcg_wav2vec/datasets/cinc.py:49-51, augment/noise_sources.py:23-36); that package is not
available here, so this module implements the subset of the format the pipeline needs:

* ``.hea`` header parsing: record line (name, n_sig, fs, sig_len) + per-signal lines
  (file name, format, gain(baseline)/units, adc fields).
* ``.dat`` signal decoding for formats 16 / 32 / 80 / 212 / 24, with physical conversion
  ``(digital - baseline) / gain`` and NaN for the format's invalid-sample sentinel.
* partial reads (``sampfrom`` / ``sampto``) for the recorded-noise augmentation path.
* a format-16 writer used by tests and synthetic-dataset fixtures.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Header:
    record_name: str
    n_sig: int
    fs: float
    sig_len: int
    file_names: list[str] = field(default_factory=list)
    formats: list[int] = field(default_factory=list)
    gains: list[float] = field(default_factory=list)
    baselines: list[int] = field(default_factory=list)
    units: list[str] = field(default_factory=list)
    adc_zeros: list[int] = field(default_factory=list)
    sig_names: list[str] = field(default_factory=list)


@dataclass
class Record:
    record_name: str
    fs: float
    p_signal: np.ndarray          # [T, n_sig] physical units, NaN where invalid
    sig_name: list[str]

    @property
    def sig_len(self) -> int:
        return self.p_signal.shape[0]


def read_header(path: str) -> Header:
    """Parse ``<path>.hea`` (``path`` may omit the extension)."""
    hea = path if path.endswith(".hea") else path + ".hea"
    with open(hea) as fh:
        lines = [ln.strip() for ln in fh
                 if ln.strip() and not ln.startswith("#")]
    rec = lines[0].split()
    name = rec[0].split("/")[0]
    n_sig = int(rec[1])
    fs = float(rec[2].split("/")[0]) if len(rec) > 2 else 250.0
    sig_len = int(rec[3]) if len(rec) > 3 else 0

    h = Header(record_name=name, n_sig=n_sig, fs=fs, sig_len=sig_len)
    for ln in lines[1:1 + n_sig]:
        parts = ln.split()
        h.file_names.append(parts[0])
        fmt = parts[1]
        for sep in ("x", ":", "+"):
            fmt = fmt.split(sep)[0]
        h.formats.append(int(fmt))
        gain, baseline, unit = 200.0, None, "mV"
        if len(parts) > 2:
            g = parts[2]
            if "/" in g:
                g, unit = g.split("/", 1)
            if "(" in g:
                g, b = g.rstrip(")").split("(")
                baseline = int(b)
            gain = float(g) if float(g) != 0 else 200.0
        adc_zero = int(parts[4]) if len(parts) > 4 else 0
        h.gains.append(gain)
        h.adc_zeros.append(adc_zero)
        h.baselines.append(baseline if baseline is not None else adc_zero)
        h.units.append(unit)
        h.sig_names.append(parts[8] if len(parts) > 8 else f"sig{len(h.sig_names)}")
    return h


def _decode(raw: bytes, fmt: int, n_sig: int) -> np.ndarray:
    """Decode interleaved samples -> int32 array ``[T, n_sig]``; NaN sentinel left to caller."""
    if fmt == 16:
        d = np.frombuffer(raw, dtype="<i2").astype(np.int32)
    elif fmt == 32:
        d = np.frombuffer(raw, dtype="<i4").astype(np.int32)
    elif fmt == 80:
        d = np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128
    elif fmt == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.int32)
        d = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        d = np.where(d >= 1 << 23, d - (1 << 24), d)
    elif fmt == 212:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.int32)
        s0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
        s1 = b[:, 2] | ((b[:, 1] & 0xF0) << 4)
        d = np.empty(2 * len(b), dtype=np.int32)
        d[0::2] = np.where(s0 >= 2048, s0 - 4096, s0)
        d[1::2] = np.where(s1 >= 2048, s1 - 4096, s1)
    else:
        raise ValueError(f"unsupported wfdb signal format {fmt}")
    usable = (len(d) // n_sig) * n_sig
    return d[:usable].reshape(-1, n_sig)


_INVALID = {16: -32768, 32: -(1 << 31), 80: -128, 212: -2048, 24: -(1 << 23)}


def read_record(path: str, sampfrom: int = 0, sampto: int | None = None) -> Record:
    """Read ``<path>.hea`` + its signal file into physical units.

    All signals must share one ``.dat`` file (the layout every dataset here uses).
    """
    h = read_header(path)
    if not h.file_names:
        raise ValueError(f"{path}: header has no signal lines")
    if len(set(h.file_names)) != 1:
        raise ValueError(f"{path}: multi-file records are not supported")
    fmt = h.formats[0]
    dat = os.path.join(os.path.dirname(path) or ".", h.file_names[0])

    bytes_per_frame = {16: 2 * h.n_sig, 32: 4 * h.n_sig, 80: h.n_sig}.get(fmt)
    with open(dat, "rb") as fh:
        if bytes_per_frame is not None:
            fh.seek(sampfrom * bytes_per_frame)
            count = -1 if sampto is None else (sampto - sampfrom) * bytes_per_frame
            raw = fh.read(count if count >= 0 else -1)
            digital = _decode(raw, fmt, h.n_sig)
        else:
            digital = _decode(fh.read(), fmt, h.n_sig)
            end = sampto if sampto is not None else digital.shape[0]
            digital = digital[sampfrom:end]
    if sampto is not None:
        digital = digital[: sampto - sampfrom]

    gains = np.asarray(h.gains, dtype=np.float64)
    baselines = np.asarray(h.baselines, dtype=np.float64)
    phys = (digital.astype(np.float64) - baselines) / gains
    sentinel = _INVALID.get(fmt)
    if sentinel is not None:
        phys[digital == sentinel] = np.nan
    return Record(record_name=h.record_name, fs=h.fs, p_signal=phys, sig_name=list(h.sig_names))


def write_record(path: str, signal: np.ndarray, fs: float, *, sig_names: list[str] | None = None,
                 gain: float = 1000.0, units: str = "mV") -> None:
    """Write a ``[T]`` / ``[T, C]`` float signal as a format-16 record (``.hea`` + ``.dat``)."""
    signal = np.asarray(signal, dtype=np.float64)
    if signal.ndim == 1:
        signal = signal[:, None]
    T, C = signal.shape
    name = os.path.basename(path)
    sig_names = sig_names or [f"sig{i}" for i in range(C)]

    digital = np.clip(np.round(signal * gain), -32767, 32767).astype("<i2")
    with open(path + ".dat", "wb") as fh:
        fh.write(digital.reshape(-1).tobytes())
    with open(path + ".hea", "w") as fh:
        fh.write(f"{name} {C} {fs:g} {T}\n")
        for i in range(C):
            fh.write(f"{name}.dat 16 {gain:g}(0)/{units} 16 0 0 0 0 {sig_names[i]}\n")
