"""CinC 2016 loaders: single-channel PCG and synchronised Training-A PCG+ECG (port of
``wav2vec_heart_sounds_tpu/data/cinc.py``).

On-disk layout is the PhysioNet CinC 2016 format (``<patient>.hea`` + signal file, read by
:mod:`.wfdb_io`) plus the split CSV protocol of :mod:`.common`. Full records are
preprocessed on the host (the PCG chain on channel 0; the ECG chain on channel 1 when the
synchronised pair is asked for, ``ecg=True``, giving ``[T, 2]`` waveforms),
balance-augmented before windowing so augmented copies are whole-record transforms (one
shared transform of the pair, ``augment_pcg_ecg``), then segmented into fixed windows; the
raw wire instead cuts un-preprocessed mono windows at the low native rate for
preprocessing on the card. Missing or unreadable records are skipped. ``pcg_augment``,
``_preprocessed``, ``_variants``, ``build_fragments`` and ``read_record`` are copies of the
originals (``tests/test_torch_imports.py``).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..augment.pipelines import AugmentConfig, augment_pcg, augment_pcg_ecg
from ..config import WindowSpec
from ..signal.segment import segment
from . import wfdb_io
from .common import (
    balanced_copy_counts,
    binary_label,
    ecg_chain,
    label_column,
    pcg_chain,
    progress,
    read_split,
)
from .fragments import Fragment, FragmentDataset


def read_record(data_dir: str, patient: str) -> tuple[np.ndarray, float]:
    rec = wfdb_io.read_record(os.path.join(data_dir, str(patient)))
    return rec.p_signal, rec.fs


def pcg_augment(wave: np.ndarray, fs: int, cfg: AugmentConfig,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Augment a mono PCG window or a [T, 2] PCG+ECG pair (one shared transform)."""
    if wave.ndim == 1:
        return augment_pcg(wave, fs, cfg, rng=rng)
    ecg_aug, pcg_aug = augment_pcg_ecg(wave[:, 1], wave[:, 0], fs, cfg, rng=rng)
    n = min(len(pcg_aug), len(ecg_aug))
    return np.stack([pcg_aug[:n], ecg_aug[:n]], axis=1)


def _preprocessed(data_dir: str, patient: str, fs_out: int, want_ecg: bool):
    """Preprocessed record waveform ([T] or [T, 2]); None when the record is unreadable."""
    try:
        signal, fs = read_record(data_dir, patient)
    except (FileNotFoundError, ValueError, OSError):
        return None
    pcg = pcg_chain(signal[:, 0], fs, fs_out)
    if not (want_ecg and signal.shape[1] > 1):
        return pcg
    ecg = ecg_chain(signal[:, 1], fs, fs_out)
    n = min(len(pcg), len(ecg))
    return np.stack([pcg[:n], ecg[:n]], axis=1)


def _variants(base: np.ndarray, copies: int, fs: int, cfg: AugmentConfig,
              rng) -> Iterator[tuple[str, np.ndarray]]:
    """The base record followed by ``copies`` fresh whole-record augmentations."""
    yield "", base
    for k in range(copies):
        yield f"#aug{k + 1}", pcg_augment(base, fs, cfg, rng=rng)


def build_fragments(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs_out: int,
    window: WindowSpec,
    ecg: bool = False,
    fold: int = 1,
    augment_num: int = 0,
    augment_config: AugmentConfig | None = None,
    balance_augment: bool = True,
    rng: np.random.Generator | None = None,
) -> list[Fragment]:
    """Load + preprocess records, expand balanced augmented copies, window into fragments."""
    df = read_split(csv_path, subset, fold)
    col = label_column(df)
    patients = [str(p) for p in df["patient"]]
    labels = [binary_label(v) for v in df[col]]
    if balance_augment:
        copy_counts = balanced_copy_counts(labels, augment_num)
    else:
        copy_counts = np.full(len(labels), max(augment_num, 0), dtype=np.int64)
    cfg = augment_config or AugmentConfig()

    kind = "PCG+ECG" if ecg else "PCG"
    fragments: list[Fragment] = []
    stream = progress(zip(patients, labels, copy_counts),
                      desc=f"Loading CinC {kind} [{subset}]", total=len(patients))
    for patient, label, copies in stream:
        base = _preprocessed(data_dir, patient, fs_out, ecg)
        if base is None:
            continue
        for tag, wave in _variants(base, int(copies), fs_out, cfg, rng):
            fragments.extend(
                Fragment(waveform=w, label=label, patient=patient + tag)
                for w in segment(wave, fs_out, window))
    return fragments


def build_raw_fragments(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs_wire: int,
    window: WindowSpec,
    fold: int = 1,
) -> list[Fragment]:
    """Raw-wire fragments: un-preprocessed mono PCG windows at the low native rate.

    Windows are cut from the raw record at ``fs_wire`` (records at other rates are
    resampled to it on the host) and normalised into the int16 wire range; the full
    preprocessing chain runs on the card per batch (``device_preprocess``), which is
    scale-invariant (it ends in abs-max). No host augment copies: the raw wire pairs with
    per-epoch augmentation on the card and the Batcher's balanced bootstrap instead."""
    from ..signal.resample import resample as host_resample

    df = read_split(csv_path, subset, fold)
    col = label_column(df)
    fragments: list[Fragment] = []
    stream = progress(zip((str(p) for p in df["patient"]),
                          (binary_label(v) for v in df[col])),
                      desc=f"Loading CinC raw [{subset}]", total=len(df))
    for patient, label in stream:
        try:
            signal, fs = read_record(data_dir, patient)
        except (FileNotFoundError, ValueError, OSError):
            continue
        pcg = np.asarray(signal[:, 0], dtype=np.float32)
        if pcg.size == 0:   # degenerate record: np.max would raise on empty
            continue
        if int(round(fs)) != fs_wire:
            pcg = host_resample(pcg, fs, fs_wire)
        peak = float(np.max(np.abs(pcg))) or 1.0
        pcg = pcg / peak
        fragments.extend(Fragment(waveform=w, label=label, patient=patient)
                         for w in segment(pcg, fs_wire, window))
    return fragments


def cinc_dataset(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs_out: int,
    window: WindowSpec,
    ecg: bool = False,
    fold: int = 1,
    augment_num: int = 0,
    augment_config: AugmentConfig | None = None,
    channel: int = -1,
) -> FragmentDataset:
    fragments = build_fragments(
        data_dir, csv_path, subset, fs_out=fs_out, window=window, ecg=ecg, fold=fold,
        augment_num=augment_num, augment_config=augment_config,
    )
    return FragmentDataset(fragments, fs=fs_out, channel=channel)
