"""Label vocabularies and balanced sampling weights.

Classification is binary (0 = normal, 1 = abnormal). The diffusion generators condition on a
per-dataset label vocabulary whose index order fixes the conditioning-embedding rows, so the
vocabularies are pinned here as immutable :class:`Vocabulary` objects (contents match
reference src/mpcg_wav2vec/datasets/labels.py:19-56 — they size the embeddings and must not
drift). The reference's torch ``WeightedRandomSampler`` has no device-side equivalent in this
framework: balanced sampling is a host-side weight vector (:func:`balance_weights`) consumed
by :class:`.loader.Batcher`'s bootstrap draw.

A copy of ``wav2vec_heart_sounds_tpu/data/labels.py``, held to the original by
``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass


@dataclass(frozen=True)
class Vocabulary:
    """Ordered conditioning-label vocabulary; index order defines embedding rows."""

    name: str
    entries: tuple

    def __len__(self) -> int:
        return len(self.entries)

    def encode(self, label) -> int:
        try:
            return self.entries.index(label)
        except ValueError as exc:
            raise KeyError(f"label {label!r} not in vocabulary '{self.name}'") from exc

    def decode(self, index: int):
        return self.entries[index]


BINARY_LABELS = (0, 1)

def _vocab(name: str, entries) -> tuple[str, Vocabulary]:
    return name, Vocabulary(name, tuple(entries))


VOCABULARIES: dict[str, Vocabulary] = dict((
    _vocab("training-a", (-1, 1)),
    _vocab("training-a-extended", ("Normal", "Benign", "MVP", "MPC", "AD")),
    _vocab("ticking-heart-multi", (-1, 1)),
    _vocab("ticking-heart-extended",
           (f"C{a}X{b}{s}" for a, b in itertools.permutations(range(1, 7), 2) for s in "NA")),
    _vocab("cinc-channels", (f"{c}{s}" for c in (2, 3, 4, 5, 6) for s in "NA")),
    _vocab("multichannel-mixed", (0, 1, 2)),
))

# Plain-tuple view kept as the stable public surface (callers index it directly).
LABEL_SETS: dict[str, tuple] = {k: v.entries for k, v in VOCABULARIES.items()}


def vocabulary(dataset: str) -> Vocabulary:
    try:
        return VOCABULARIES[dataset]
    except KeyError as exc:
        raise NotImplementedError(f"No label vocabulary for dataset '{dataset}'") from exc


def label_set(dataset: str) -> tuple:
    return vocabulary(dataset).entries


def num_classes(dataset: str) -> int:
    return len(vocabulary(dataset))


def label_to_index(dataset: str, label) -> int:
    return vocabulary(dataset).encode(label)


def index_to_label(dataset: str, index: int):
    return vocabulary(dataset).decode(index)


def balance_weights(labels) -> "np.ndarray":
    """Per-item sampling weights under which every class is drawn equally often."""
    import numpy as np

    labels = np.asarray(list(labels), dtype=np.int64)
    inv = 1.0 / np.maximum(np.bincount(labels), 1).astype(np.float64)
    return inv[labels]
