"""Multichannel wearable-vest PCG loader (copy of ``wav2vec_heart_sounds_tpu/data/vest.py``;
only the imports differ, each function and class is held to the original by
``tests/test_torch_imports.py``).

One multichannel WAV per recording (integer PCM scaled to [-1, 1]); the fixed physical
layout — PCG microphones 1-7 in WAV columns 0-6, ECG lead ``E`` column 7, ``E2`` column 8 —
and the rest of the behavior (filename-substring patient matching, per-channel PCG/ECG
chains, min-length channel stack, windowing, augmentation deferred to the FragmentDataset
with one transform shared across channels) follow reference
src/mpcg_wav2vec/datasets/vest.py:27-113.

The requested channel subset is resolved once into a :class:`ChannelPlan` (WAV columns +
per-channel chain selection) instead of being re-derived per record. Under
``device_augment`` the host keeps the head of the pipeline
(:func:`multi_augment_host_residual`) and the card runs the rest
(:func:`..augment.torchaug.augment_multi_pcg_batch`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import numpy as np
from scipy.io import wavfile

from ..augment.pipelines import AugmentConfig, augment_multi_pcg
from ..config import WindowSpec
from ..signal.segment import segment
from .common import (
    binary_label,
    ecg_chain,
    label_column,
    pcg_chain,
    progress,
    read_split,
    stack_min_length,
)
from .fragments import Fragment, FragmentDataset

# Microphone / lead name -> WAV column index (fixed physical vest layout).
VEST_CHANNEL_MAP: dict[object, int] = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, "E": 7, "E2": 8}

ECG_LEADS = frozenset({"E", "E2"})


@dataclass(frozen=True)
class ChannelPlan:
    """Resolved channel subset: WAV column + which preprocessing chain each one takes."""

    columns: tuple[int, ...]
    is_ecg: tuple[bool, ...]

    @classmethod
    def resolve(cls, channels: list) -> "ChannelPlan":
        picked = [(VEST_CHANNEL_MAP[c], c in ECG_LEADS)
                  for c in channels if c in VEST_CHANNEL_MAP]
        return cls(columns=tuple(c for c, _ in picked), is_ecg=tuple(e for _, e in picked))

    def preprocess(self, signal: np.ndarray, fs: float, fs_out: int) -> np.ndarray | None:
        """[T_raw, C_wav] -> [T, C_plan] through per-channel chains; None if no column fits."""
        chains = [(ecg_chain if is_ecg else pcg_chain)(signal[:, col], fs, fs_out)
                  for col, is_ecg in zip(self.columns, self.is_ecg)
                  if col < signal.shape[1]]
        return stack_min_length(chains) if chains else None


def read_vest_wav(path: str) -> tuple[np.ndarray, int]:
    """Multichannel WAV as float32 ``[T, C]`` (integer PCM scaled into [-1, 1])."""
    fs, signal = wavfile.read(path)
    if np.issubdtype(signal.dtype, np.integer):
        signal = signal.astype(np.float32) / np.iinfo(signal.dtype).max
    else:
        signal = signal.astype(np.float32)
    return (signal[:, None] if signal.ndim == 1 else signal), fs


def patient_files(data_dir: str, patient: str) -> list[str]:
    """WAVs belonging to ``patient``, matched by filename substring."""
    return sorted(
        os.path.join(data_dir, name)
        for name in os.listdir(data_dir)
        if patient in name and name.lower().endswith(".wav")
    )


def build_fragments(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs_out: int,
    window: WindowSpec,
    channels: list,
    fold: int = 1,
) -> list[Fragment]:
    df = read_split(csv_path, subset, fold)
    col = label_column(df)
    plan = ChannelPlan.resolve(channels)

    fragments: list[Fragment] = []
    rows = progress(list(zip(df["patient"], df[col])),
                    desc=f"Loading vest ({len(plan.columns)}ch) [{subset}]")
    for patient, raw_label in rows:
        patient, label = str(patient), binary_label(raw_label)
        for wav_path in patient_files(data_dir, patient):
            signal, fs = read_vest_wav(wav_path)
            stacked = plan.preprocess(signal, fs, fs_out)
            if stacked is None:
                continue
            fragments.extend(
                Fragment(waveform=w, label=label, patient=patient)
                for w in segment(stacked, fs_out, window))
    return fragments


def multi_augment(wave: np.ndarray, fs: int, cfg: AugmentConfig,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """One shared augmentation across all channels (preserves inter-channel phase)."""
    augmented = augment_multi_pcg(list(wave.T), fs, cfg, rng=rng)
    return stack_min_length(augmented)


def multi_augment_host_residual(wave: np.ndarray, fs: int, cfg: AugmentConfig,
                                rng: np.random.Generator | None = None,
                                recorded_on_device: bool = False) -> np.ndarray:
    """Host-side residue of the vest pipeline under ``--device-augment``.

    Runs the *head* of the multichannel pipeline in its reference order — normalise,
    the first white-noise gate, micro time-stretch (shared rate across mics) — so that
    the on-device tail (wander -> noise -> recorded noise,
    :func:`..augment.torchaug.augment_multi_pcg_batch`) composes to the exact host
    ordering of :func:`..augment.pipelines.augment_multi_pcg`. Time-stretch has no
    tensor form and must stay host-side, exactly the subset the reference keeps on the
    NumPy side (src/mpcg_wav2vec/augment/torchaug.py:9-11). Recorded-noise mixing moves
    on-device when the caller ships a noise bank (``recorded_on_device=True``, see
    ``noise_sources.pcg_noise_bank``); otherwise it stays here as a fallback — out of
    reference order (before wander/noise instead of last) but feature-preserving.
    """
    from ..augment import pipelines as PL
    from ..augment import primitives as P
    from ..augment.noise_sources import pcg_noise
    from ..signal.normalize import abs_max_normalise

    rng = P.default_rng(rng)
    chans = [abs_max_normalise(c.copy()) for c in wave.T]
    if PL._chance(PL.MULTI_PROB_NOISE / 4, rng):
        chans = [P.add_white_noise(c, rng) for c in chans]
    if PL._chance(PL.MULTI_PROB_TIME_WARP, rng):
        rate = P.randfloat(*PL.MULTI_STRETCH, rng=rng)
        chans = [abs_max_normalise(P.time_stretch(c, fs, rate, keep_length=True))
                 for c in chans]
    if (not recorded_on_device and PL._chance(PL.MULTI_PROB_REAL_NOISE, rng)
            and cfg.ephnogram_dir):
        shared = pcg_noise(fs, len(chans[0]), cfg.ephnogram_dir, rng)
        chans = [abs_max_normalise(c + shared) for c in chans]
    return stack_min_length(chans)


def vest_dataset(
    data_dir: str,
    csv_path: str,
    subset: str,
    *,
    fs_out: int,
    window: WindowSpec,
    channels: list,
    fold: int = 1,
    augment_num: int = 0,
    augment_config: AugmentConfig | None = None,
    channel: int = -1,
    device_augment: bool = False,
    recorded_on_device: bool = False,
) -> FragmentDataset:
    fragments = build_fragments(data_dir, csv_path, subset, fs_out=fs_out, window=window,
                                channels=channels, fold=fold)
    cfg = augment_config or AugmentConfig()
    if device_augment:
        augment_fn = partial(multi_augment_host_residual, cfg=cfg,
                             recorded_on_device=recorded_on_device)
    else:
        augment_fn = partial(multi_augment, cfg=cfg)
    return FragmentDataset(fragments, fs=fs_out, augment_num=augment_num,
                           augment_fn=augment_fn, channel=channel)
