"""Loader for synthetic waveform datasets produced by the diffusion generators.

A generated dataset is a directory of WAVs plus a ``REFERENCE.csv`` manifest with columns
``patient,label,file`` (labels already binary) — the format :func:`..train.generate.
generate_dataset` writes and the format the reference reads back
(src/mpcg_wav2vec/datasets/generated.py:22-47). Loading goes mono-collapse -> resample ->
abs-max -> window, producing the same Fragment list real loaders produce so synthetic data
mixes transparently into schedules. ``proportion`` subsamples the manifest with a seed.

A copy of ``wav2vec_heart_sounds_tpu/data/generated.py`` with each name imported from its
own module, held to the original function by function by ``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy.io import wavfile

from ..config import WindowSpec
from ..signal.normalize import abs_max_normalise
from ..signal.resample import resample
from ..signal.segment import segment
from .common import progress
from .fragments import Fragment


def read_manifest(manifest_dir: str) -> list[dict]:
    with open(os.path.join(manifest_dir, "REFERENCE.csv"), newline="") as fh:
        return list(csv.DictReader(fh))


def subsample(rows: list[dict], proportion: float, seed: int) -> list[dict]:
    """A seeded ``proportion`` subset of manifest rows (all rows when proportion >= 1)."""
    if proportion >= 1.0:
        return rows
    keep = np.random.default_rng(seed).permutation(len(rows))[:round(len(rows) * proportion)]
    return [rows[i] for i in sorted(keep)]


def generated_fragments(manifest_dir: str, *, fs_out: int, window: WindowSpec,
                        proportion: float = 1.0, seed: int = 0) -> list[Fragment]:
    """Read a generated dataset directory into windowed fragments."""
    rows = subsample(read_manifest(manifest_dir), proportion, seed)
    fragments: list[Fragment] = []
    for row in progress(rows, desc="Loading synthetic", unit="wav"):
        path = os.path.join(manifest_dir, row["file"])
        if not os.path.exists(path):
            continue
        sr, raw = wavfile.read(path)
        mono = np.asarray(raw, dtype=np.float64)
        if mono.ndim == 2:
            mono = mono.mean(axis=1)
        wave = abs_max_normalise(resample(mono, sr, fs_out))
        label = 1 if int(row["label"]) == 1 else 0
        fragments.extend(Fragment(waveform=w, label=label, patient=row["patient"])
                         for w in segment(wave, fs_out, window))
    return fragments
