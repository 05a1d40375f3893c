"""Patient-level, label-stratified train/valid/test split CSVs (port of ``data/splits.py``,
without pandas).

The output contract is the JAX package's: a CSV with columns ``patient, label, split[,
split2, ...]`` where each ``split<n>`` column is an independent patient-level assignment
valued train/valid/test, stratified by label, drawn from ``default_rng(seed + fold)``, read
back by :func:`.common.read_split`. :func:`make_splits` draws exactly what the original
draws: subjects in sorted record order, each labelled by its first record; per fold, one
``subset_names`` permutation per label, labels in sorted order. It returns the table as
plain columns (``{name: list}``), and :func:`write_splits` writes them byte for byte as
``DataFrame.to_csv(index=False)`` does. ``SplitRatios`` and ``read_cinc_labels`` are copies,
held to the originals by ``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class SplitRatios:
    train: float = 0.6
    valid: float = 0.2
    test: float = 0.2

    def __post_init__(self):
        total = self.train + self.valid + self.test
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"split ratios must sum to 1.0, got {total}")

    def subset_names(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """``n`` shuffled train/valid/test assignments at these ratios."""
        n_test = int(round(n * self.test))
        n_valid = int(round(n * self.valid))
        names = np.full(n, "train", dtype=object)
        names[:n_test] = "test"
        names[n_test:n_test + n_valid] = "valid"
        return rng.permutation(names)                  # random positions, exact counts


def read_cinc_labels(data_dir: str) -> dict[str, int]:
    """Read ``<data_dir>/REFERENCE.csv`` rows ``record,label`` into {record: label}."""
    path = os.path.join(data_dir, "REFERENCE.csv")
    with open(path, newline="") as fh:
        labels = {row[0].strip(): int(row[1])
                  for row in csv.reader(fh) if len(row) >= 2 and row[0]}
    if not labels:
        raise ValueError(f"no labels read from {path}")
    return labels


def make_splits(
    labels: dict[str, int],
    *,
    folds: int = 5,
    ratios: SplitRatios | None = None,
    seed: int = 42,
    patient_fn=None,
) -> dict[str, list]:
    """Stratified patient-level split table, one independent column per fold.

    All records of a patient land in the same subset; stratification is by the patient's
    label (a patient's records share a label in these datasets — the first record's label
    is taken). Each fold draws from its own ``default_rng(seed + fold)``.
    """
    ratios = ratios or SplitRatios()
    patients = sorted(labels)
    table = {"patient": patients, "label": [labels[p] for p in patients]}
    subject = [patient_fn(p) for p in patients] if patient_fn else patients
    subject_label: dict = {}
    for name, label in zip(subject, table["label"]):
        subject_label.setdefault(name, label)          # the first record's label

    for fold in range(1, folds + 1):
        rng = np.random.default_rng(seed + fold)
        assignment: dict = {}
        for label in sorted(set(subject_label.values())):
            members = [name for name, lab in subject_label.items() if lab == label]
            assignment.update(zip(members, ratios.subset_names(len(members), rng)))
        table["split" if fold == 1 else f"split{fold}"] = [assignment[s] for s in subject]
    return table


def split_counts(table: dict[str, list]) -> dict[str, dict[str, int]]:
    """Each split column's subset counts, most frequent first (ties in order of first
    appearance), as ``Series.value_counts().to_dict()`` gives them."""
    counts = {}
    for column, values in table.items():
        if column.startswith("split"):
            seen: dict[str, int] = {}
            for value in values:
                seen[value] = seen.get(value, 0) + 1
            counts[column] = dict(sorted(seen.items(), key=lambda kv: -kv[1]))
    return counts


def write_splits(table: dict[str, list], out_path: str | Path) -> str:
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(table)
        writer.writerows(zip(*table.values()))
    return str(out)


def make_splits_from_dirs(data_dirs: list[str], **kwargs) -> dict[str, list]:
    """Merge CinC ``REFERENCE.csv`` labels from several directories, then split."""
    merged: dict[str, int] = {}
    for d in data_dirs:
        merged.update(read_cinc_labels(d))
    return make_splits(merged, **kwargs)
