"""Shared dataset-builder plumbing: split-CSV protocol, label mapping, preprocessing.

Port of ``wav2vec_heart_sounds_tpu/data/common.py`` without pandas. The split protocol: a
reference CSV with a ``patient`` column, a binary label column (one of
``abnormality``/``label``/``diagnosis``) and per-fold ``split``/``split<n>`` columns valued
train/valid/test. :func:`read_split` reads it with the ``csv`` module under
``pd.read_csv(path, comment="#")``'s rules as far as the protocol uses them: text after a
``#`` is ignored, blank lines are skipped, and a column whose every cell is an integer
holds ints (a float column floats, anything else strings), so ``str(patient)`` and the
label ints come out as pandas gives them. ``subjects_and_labels``,
``balanced_copy_counts`` and ``progress`` are copies, held to the originals by
``tests/test_torch_imports.py``.

Preprocessing (:func:`pcg_chain`, :func:`ecg_chain`) runs the C++ host library
(:mod:`..native`, ``native/fastproc.cpp``) when it builds, and the NumPy oracle
(:mod:`..signal.preprocess`) otherwise or under ``W2VHS_NO_NATIVE=1``, as the JAX package's
does. ``stack_min_length`` is a copy too.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np

LABEL_COLUMNS = ("abnormality", "label", "diagnosis")


def _parse(value: str, kind):
    return math.nan if value == "" else kind(value)


def _column(cells: list[str]) -> list:
    """The cells as pandas infers one column: ints, else floats, else strings."""
    for kind in (int, float):
        if kind is int and "" in cells:
            continue                               # pandas: a missing cell makes ints float
        try:
            return [_parse(c, kind) for c in cells]
        except ValueError:
            pass
    return [math.nan if c == "" else c for c in cells]


class SplitTable:
    """The rows of a split CSV by column (the part of a DataFrame the builders use)."""

    def __init__(self, columns: list[str], data: dict[str, list]):
        self.columns = columns
        self._data = data

    def __len__(self) -> int:
        return len(self._data[self.columns[0]]) if self.columns else 0

    def __getitem__(self, column: str) -> list:
        return self._data[column]

    def where(self, column: str, value) -> "SplitTable":
        keep = [v == value for v in self._data[column]]
        return SplitTable(self.columns, {c: [v for v, k in zip(vals, keep) if k]
                                         for c, vals in self._data.items()})


def read_csv(csv_path: str) -> SplitTable:
    """``pd.read_csv(csv_path, comment="#")`` for the split protocol's plain CSVs."""
    with open(csv_path, newline="") as fh:
        lines = [line.split("#", 1)[0] for line in fh]
    rows = [r for r in csv.reader(lines) if r and any(cell.strip() for cell in r)]
    if not rows:
        return SplitTable([], {})
    header, body = rows[0], rows[1:]
    data = {}
    for i, name in enumerate(header):
        data[name] = _column([r[i] if i < len(r) else "" for r in body])
    return SplitTable(header, data)


def read_split(csv_path: str, subset: str, fold: int = 1) -> SplitTable:
    """Rows of the reference CSV assigned to ``subset`` in fold ``fold`` (or every row)."""
    table = read_csv(csv_path)
    if subset == "all":
        return table
    return table.where("split" if fold == 1 else f"split{fold}", subset)


def label_column(df: SplitTable) -> str:
    for col in LABEL_COLUMNS:
        if col in df.columns:
            return col
    raise KeyError(f"No label column ({LABEL_COLUMNS}) in split CSV columns {list(df.columns)}")


def binary_label(raw) -> int:
    """CinC label -> {0: normal, 1: abnormal}; accepts the -1/1 and 0/1 encodings."""
    return 1 if int(raw) == 1 else 0


def subjects_and_labels(df: SplitTable) -> list[tuple[str, int]]:
    """(patient, binary label) pairs in CSV row order."""
    col = label_column(df)
    return [(str(p), binary_label(v)) for p, v in zip(df["patient"], df[col])]


def balanced_copy_counts(labels: list[int], augment_num: int) -> np.ndarray:
    """Augmented copies per record so every class contributes equally many copies.

    The majority class gets ``augment_num`` copies per record; rarer classes get
    proportionally more (``round(augment_num * max_count / class_count)``).
    """
    arr = np.asarray(labels, dtype=np.int64)
    if augment_num <= 0 or len(arr) == 0:
        return np.zeros(len(arr), dtype=np.int64)
    counts = np.bincount(arr)
    return np.round(augment_num * counts.max() / counts[arr]).astype(np.int64)


def progress(iterable, desc: str, unit: str = "rec", total: int | None = None):
    """tqdm when a tty wants it; plain passthrough otherwise (keeps logs clean)."""
    try:
        from tqdm import tqdm

        return tqdm(iterable, desc=desc, unit=unit, total=total)
    except ImportError:                               # pragma: no cover
        return iterable


def _native_enabled() -> bool:
    from .. import native

    return os.environ.get("W2VHS_NO_NATIVE") != "1" and native.available()


def pcg_chain(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Full PCG preprocessing chain on the host — C++ when available, the oracle otherwise."""
    if _native_enabled():
        from .. import native

        return native.preprocess_pcg(x, fs_in, fs_out)
    from ..signal.preprocess import preprocess_pcg

    return preprocess_pcg(x, fs_in, fs_out)


def ecg_chain(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Full ECG preprocessing chain on the host — C++ when available, the oracle otherwise."""
    if _native_enabled():
        from .. import native

        return native.preprocess_ecg(x, fs_in, fs_out)
    from ..signal.preprocess import preprocess_ecg

    return preprocess_ecg(x, fs_in, fs_out)


def stack_min_length(channels: list[np.ndarray]) -> np.ndarray:
    """Stack per-channel signals to ``[T, C]`` at the shortest common length."""
    n = min(len(c) for c in channels)
    return np.stack([c[:n] for c in channels], axis=1)
