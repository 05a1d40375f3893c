"""Datasets feeding the DiffWave / WaveGrad generators.

Each item is a (reference waveform, conditioning waveform) pair at the generator rate plus an
integer class label: the reference is the diffusion target, the conditioning is encoded to a
log-mel ``con_spec``. Behavior matches reference src/mpcg_wav2vec/datasets/generative.py:27-161:
optional cardiac-cycle rearrangement diversifies targets while keeping the pair aligned
(one shared permutation), both waveforms get 10 ms edge fades and are cropped/padded to
``crop_frames * hop_length`` samples, and the centred STFT's extra frame is pinned off so the
upsampled conditioner matches the waveform length exactly.

Structured as pure per-item pipeline stages (:func:`rearranged_pair`, :func:`framed`,
:func:`pinned_mel`) around a slim index container, so each stage is unit-testable and the
item assembly reads as the pipeline it is.

A copy of ``wav2vec_heart_sounds_tpu/data/generative.py`` with each name imported from its
own module (the port's ``signal`` package re-exports nothing), held to the original function
by function by ``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..signal.normalize import abs_max_normalise
from ..signal.resample import resample
from ..signal.spectrogram import MelConfig, add_chirp, log_mel
from ..signal.segment import pad_or_crop
from . import heart_cycles, wfdb_io
from .common import binary_label, label_column, read_split
from .labels import label_to_index


@dataclass
class GenRecord:
    reference: np.ndarray            # target waveform at fs
    conditioning: np.ndarray         # conditioning waveform at fs
    label: int
    patient: str
    segment_path: str | None = None  # per-recording cardiac-cycle segmentation JSON


def edge_fade(x: np.ndarray, n: int = 128) -> np.ndarray:
    if len(x) < 2 * n:
        return x
    ramp = np.linspace(0.0, 1.0, n)
    x = x.copy()
    x[:n] *= ramp
    x[-n:] *= ramp[::-1]
    return x


def rearranged_pair(rec: GenRecord, fs: int, target_len: int, fade_samples: int,
                    prob_contiguous: float, random_start: bool):
    """Cycle-rearranged (reference, conditioning) rebuilt to ``target_len``; None if the
    record has no usable segmentation (fewer than two cycles)."""
    joins = heart_cycles.load_join_indices(rec.segment_path, fs)
    pair = {"ref": heart_cycles.split_cycles(abs_max_normalise(rec.reference), joins),
            "con": heart_cycles.split_cycles(abs_max_normalise(rec.conditioning), joins)}
    if min(len(pair["ref"]), len(pair["con"])) < 2:
        return None
    arranged = heart_cycles.rearrange(pair, prob_contiguous=prob_contiguous,
                                      random_start=random_start)
    return (heart_cycles.rebuild(arranged["ref"], target_len, fade_samples),
            heart_cycles.rebuild(arranged["con"], target_len, fade_samples))


def framed(x: np.ndarray, crop: int, fade_samples: int) -> np.ndarray:
    """Edge-faded waveform pinned to exactly ``crop`` samples."""
    out, _ = pad_or_crop(edge_fade(x, fade_samples), crop)
    return out


def pinned_mel(con: np.ndarray, mel: MelConfig, crop_frames: int) -> np.ndarray:
    """log-mel of the conditioner with the frame count pinned to ``crop_frames``.

    A centred STFT yields one frame more than crop_frames * hop samples; trimming (or
    zero-padding short inputs) keeps the upsampled conditioner exactly waveform-length.
    """
    spec = log_mel(con, mel).astype(np.float32)
    frames = spec.shape[-1]
    if frames >= crop_frames:
        return spec[..., :crop_frames]
    return np.pad(spec, [(0, 0), (0, crop_frames - frames)])


class GenerativeDataset:
    def __init__(self, records: list[GenRecord], fs: int, mel: MelConfig,
                 crop_frames: int, hop_length: int, *, rearrange_cycles: bool = True,
                 prob_contiguous: float = 0.0, random_start: bool = True,
                 fade_ms: float = 10.0):
        self.records = records
        self.fs = fs
        self.mel = mel
        self.crop_frames = crop_frames
        self.crop = crop_frames * hop_length
        self.rearrange_cycles = rearrange_cycles
        self.prob_contiguous = prob_contiguous
        self.random_start = random_start
        self.fade_samples = int(round(fade_ms / 1000.0 * fs))

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> dict:
        rec = self.records[idx]
        pair = None
        if self.rearrange_cycles and rec.segment_path:
            try:
                pair = rearranged_pair(rec, self.fs, self.crop, self.fade_samples,
                                       self.prob_contiguous, self.random_start)
            except (OSError, KeyError, ValueError):
                pair = None   # defective segmentation -> fall back to the raw waveform
        ref, con = pair or (abs_max_normalise(rec.reference),
                            abs_max_normalise(rec.conditioning))

        ref = framed(ref, self.crop, self.fade_samples).astype(np.float32)
        con = framed(con, self.crop, self.fade_samples).astype(np.float32)
        return {
            "ref_audio": ref,
            "con_audio": con,
            "con_spec": pinned_mel(con, self.mel, self.crop_frames),
            "label": int(rec.label),
            "seg_wave": ref.copy(),
            "chirp_wave": add_chirp(ref, self.fs).astype(np.float32),
            "patient": rec.patient,
        }


def cinc_generative_dataset(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs: int,
    mel: MelConfig,
    crop_frames: int,
    hop_length: int,
    label_vocab: str = "training-a",
    condition_on_ecg: bool = False,
    fold: int = 1,
    segment_dir: str | None = None,
    rearrange_cycles: bool = True,
    prob_contiguous: float = 0.0,
) -> GenerativeDataset:
    """Generator dataset from CinC records (PCG reference; PCG-or-ECG conditioning)."""
    df = read_split(csv_path, subset, fold)
    col = label_column(df)

    records = []
    for patient, raw in zip(df["patient"], df[col]):
        patient = str(patient)
        try:
            rec = wfdb_io.read_record(os.path.join(data_dir, patient))
        except (FileNotFoundError, ValueError, OSError):
            continue
        sig = np.nan_to_num(rec.p_signal)
        pcg = resample(sig[:, 0], rec.fs, fs)
        con_col = 1 if (condition_on_ecg and sig.shape[1] > 1) else 0
        con = pcg if con_col == 0 else resample(sig[:, con_col], rec.fs, fs)
        seg = os.path.join(segment_dir, f"{patient}.json") if segment_dir else None
        records.append(GenRecord(
            reference=pcg, conditioning=con,
            label=label_to_index(label_vocab, 1 if binary_label(raw) else -1),
            patient=patient,
            segment_path=seg if seg and os.path.exists(seg) else None,
        ))
    return GenerativeDataset(records, fs=fs, mel=mel, crop_frames=crop_frames,
                             hop_length=hop_length, rearrange_cycles=rearrange_cycles,
                             prob_contiguous=prob_contiguous)
