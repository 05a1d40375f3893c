"""In-memory fragment dataset shared by the CinC and vest classifiers.

Copy of ``wav2vec_heart_sounds_tpu/data/fragments.py`` (numpy only): the original cannot
be imported without jax, flax and pandas, which its package ``__init__`` pulls in.
``tests/test_torch_imports.py`` holds the copy to the original.

A *fragment* is one fixed-length window with its binary label and source patient
(role of reference src/mpcg_wav2vec/datasets/fragments.py:23-90). The dataset is kept
array-shaped rather than item-shaped:

* the augmented-copy expansion plan (class-balanced: the minority class receives
  proportionally more copies) is computed **vectorised** at construction into two parallel
  arrays — ``source index`` and ``is augmented`` — instead of a per-item Python list;
* base windows of equal shape are stacked once into a single ``[N, T(, C)]`` array, so the
  Batcher can assemble a whole batch with one fancy index (:meth:`FragmentDataset.gather`)
  instead of N ``__getitem__`` calls;
* augmentation stays lazy (fresh per draw, matching the reference's per-epoch-fresh
  semantics) with an optional pin-after-first-draw cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

AugmentFn = Callable[[np.ndarray, int], np.ndarray]


@dataclass
class Fragment:
    waveform: np.ndarray   # [T] (mono) or [T, C] (multichannel)
    label: int
    patient: str


def class_counts(labels) -> dict[int, int]:
    values, counts = np.unique(np.fromiter(labels, dtype=np.int64), return_counts=True)
    return dict(zip(values.tolist(), counts.tolist()))


def _expansion_plan(labels: np.ndarray, augment_num: int,
                    balance: bool) -> tuple[np.ndarray, np.ndarray]:
    """(source_index, is_augmented) arrays for the balanced copy expansion.

    Each fragment contributes itself plus ``copies`` augmented draws, where the minority
    class gets ``round(augment_num * max_count / class_count)`` copies.
    """
    n = len(labels)
    if augment_num <= 0 or n == 0:
        return np.arange(n, dtype=np.int64), np.zeros(n, dtype=bool)
    if balance:
        counts = np.bincount(labels)
        copies = np.round(augment_num * counts.max() / counts[labels]).astype(np.int64)
    else:
        copies = np.full(n, augment_num, dtype=np.int64)
    reps = 1 + copies
    src = np.repeat(np.arange(n, dtype=np.int64), reps)
    is_aug = np.ones(len(src), dtype=bool)
    is_aug[np.cumsum(reps) - reps] = False      # first slot of each group = the original
    return src, is_aug


class FragmentDataset:
    """Array-planned sequence of training items with lazy, per-draw-fresh augmentation."""

    def __init__(
        self,
        fragments: Sequence[Fragment],
        fs: int,
        augment_num: int = 0,
        augment_fn: AugmentFn | None = None,
        balance: bool = True,
        channel: int = -1,
        cache_augmented: bool = False,
    ):
        self.fragments = list(fragments)
        self.fs = fs
        self.augment_fn = augment_fn
        self.channel = channel
        self.cache_augmented = cache_augmented
        self._cache: dict[int, np.ndarray] = {}

        base_labels = np.asarray([f.label for f in self.fragments], dtype=np.int64)
        self.src, self.is_augmented = _expansion_plan(
            base_labels, augment_num if augment_fn is not None else 0, balance)
        self._labels = base_labels[self.src] if len(self.src) else base_labels

        # Stack equal-shape base windows once; heterogeneous shapes fall back to item paths.
        shapes = {f.waveform.shape for f in self.fragments}
        self._base: np.ndarray | None = None
        if len(shapes) == 1:
            self._base = np.stack([np.asarray(f.waveform, dtype=np.float32)
                                   for f in self.fragments])

    @property
    def labels(self) -> list[int]:
        return self._labels.tolist()

    def __len__(self) -> int:
        return len(self.src)

    def _select_channel(self, wave: np.ndarray) -> np.ndarray:
        if wave.ndim == 2 and self.channel != -1:
            return wave[:, self.channel]
        return wave

    def _waveform(self, idx: int) -> np.ndarray:
        i = int(self.src[idx])
        if self.is_augmented[idx] and self.augment_fn is not None:
            if self.cache_augmented and idx in self._cache:
                return self._cache[idx]
            wave = np.ascontiguousarray(
                np.asarray(self.augment_fn(self.fragments[i].waveform, self.fs),
                           dtype=np.float32))
            if self.cache_augmented:
                self._cache[idx] = wave
            return wave
        if self._base is not None:
            return self._base[i]
        return np.asarray(self.fragments[i].waveform, dtype=np.float32)

    def __getitem__(self, idx: int) -> dict:
        wave = self._select_channel(self._waveform(idx))
        frag = self.fragments[int(self.src[idx])]
        return {
            "waveform": np.ascontiguousarray(np.asarray(wave, dtype=np.float32)),
            "label": int(frag.label),
            "patient": frag.patient,
            "augmented": bool(self.is_augmented[idx]),
        }

    def gather(self, indices: np.ndarray) -> dict:
        """Assemble a whole batch: one fancy index when every item is a stacked base window.

        Falls back to per-item draws for augmented/heterogeneous items so the fast and slow
        paths compose within one batch.
        """
        indices = np.asarray(indices, dtype=np.int64)
        aug_positions = self.is_augmented[indices] & (self.augment_fn is not None)
        if self._base is not None:
            waves = self._base[self.src[indices]]
            if self.channel != -1 and waves.ndim == 3:
                waves = waves[:, :, self.channel]
            waves = np.ascontiguousarray(waves)
            if aug_positions.any():
                waves = waves.copy()
                for pos in np.flatnonzero(aug_positions):
                    w = self._select_channel(self._waveform(int(indices[pos])))
                    row = np.zeros_like(waves[pos])     # augment may change the length
                    n = min(len(w), len(row))
                    row[:n] = w[:n]
                    waves[pos] = row
        else:
            items = [self._select_channel(self._waveform(int(i))) for i in indices]
            from .loader import pad_batch
            waves = pad_batch(items)
        return {
            "waveform": waves,
            "label": self._labels[indices].astype(np.int32),
            "patient": [self.fragments[int(self.src[i])].patient for i in indices],
            # Expansion-plan flag per row (False = the pristine original): on-device
            # augmentation uses it to leave originals untouched, mirroring the host
            # path where augment_fn runs only on replica draws.
            "augmented": self.is_augmented[indices].copy(),
        }
