"""Training-schedule configuration (staged real + synthetic fine-tuning).

Parses the schedule JSON format the reference defines (src/mpcg_wav2vec/datasets/schedule.py:
19-139 — a fixed ``test_set``/``valid_set``, named real/generated ``datasets`` each with
``augment_num`` and ``proportion``, optional ``combined_datasets`` built from those, and an
ordered ``schedule`` of stages with ``letskip``), but normalises everything into this
framework's own shape: every dataset — single or combined — becomes a tuple of
:class:`SourceSpec` entries, so runners iterate ``spec.sources`` uniformly instead of
branching on scalar-vs-list fields. The reference's scalar/list field views remain available
as derived properties for compatibility. Validation errors carry the JSON path that failed
and are wrapped as ``ValueError("Invalid schedule: …")``.

A copy of ``wav2vec_heart_sounds_tpu/data/schedule.py``, held to the original by
``tests/test_torch_imports.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class EvalSet:
    data: str
    split: str
    segment: str
    augment_num: int = 0


@dataclass(frozen=True)
class SourceSpec:
    """One concrete data source inside a (possibly combined) dataset."""

    path: str
    split: str
    segment: str
    gen_data: bool
    proportion: float = 1.0


@dataclass(frozen=True)
class DatasetSpec:
    """A named stage dataset: one source, or several when built from base sets."""

    name: str
    sources: tuple[SourceSpec, ...]
    augment_num: int
    base_sets: tuple[str, ...] = ()

    @property
    def combined(self) -> bool:
        return bool(self.base_sets)

    # Scalar-or-list views over the sources (the reference's field shapes).
    def _view(self, field: str):
        values = [getattr(s, field) for s in self.sources]
        return values if self.combined else values[0]

    @property
    def path(self):
        return self._view("path")

    @property
    def split(self):
        return self._view("split")

    @property
    def segment(self):
        return self._view("segment")

    @property
    def gen_data(self):
        return self._view("gen_data")

    @property
    def proportion(self):
        return self._view("proportion")


@dataclass(frozen=True)
class Stage:
    key: str
    epochs: int
    letskip: bool = False


@dataclass
class Schedule:
    test_set: EvalSet
    valid_set: EvalSet
    datasets: dict[str, DatasetSpec]
    stages: list[Stage]

    def resolved_stages(self) -> list[tuple[DatasetSpec, int, bool]]:
        return [(self.datasets[s.key], s.epochs, s.letskip) for s in self.stages]

    def _collect(self, field: str) -> list[str]:
        own = [getattr(self.test_set, field), getattr(self.valid_set, field)]
        source_field = "path" if field == "data" else field
        own += [getattr(s, source_field)
                for d in self.datasets.values() if not d.combined
                for s in d.sources]
        return own

    @property
    def data_paths(self) -> list[str]:
        return self._collect("data")

    @property
    def split_paths(self) -> list[str]:
        return self._collect("split")

    @property
    def segment_paths(self) -> list[str]:
        return self._collect("segment")


def _fraction(value, where: str) -> float:
    f = float(value)
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"{where}: proportion must be in [0, 1], got {f}")
    return f


def _count(value, where: str) -> int:
    n = int(value)
    if n < 0:
        raise ValueError(f"{where}: augment_num must be non-negative, got {n}")
    return n


def _source(raw: dict, where: str) -> SourceSpec:
    return SourceSpec(path=raw["path"], split=raw["split"], segment=raw["segment"],
                      gen_data=bool(raw["gen_data"]),
                      proportion=_fraction(raw.get("proportion", 1.0), where))


def _combined(name: str, raw: dict, datasets: dict[str, DatasetSpec]) -> DatasetSpec:
    bases = []
    for base_name in raw["base_sets"]:
        if base_name not in datasets:
            raise ValueError(
                f"combined dataset '{name}' references unknown base set '{base_name}'")
        bases.append(datasets[base_name])
    proportions = [_fraction(p, f"combined_datasets.{name}") for p in raw["proportion"]]
    # Flatten EVERY source of each base (a base may itself be a combined set) — reading
    # only sources[0] silently dropped the rest of a combined base's data. For a plain
    # base the combined weight REPLACES the base's own proportion (the schedule-JSON
    # contract); for a combined base the nested weights scale multiplicatively.
    sources = tuple(
        SourceSpec(path=s.path, split=s.split, segment=s.segment, gen_data=s.gen_data,
                   proportion=(p * s.proportion) if b.base_sets else p)
        for b, p in zip(bases, proportions)
        for s in b.sources)
    default_augment = min(b.augment_num for b in bases)
    return DatasetSpec(
        name=name, sources=sources,
        augment_num=_count(raw.get("augment_num", default_augment),
                           f"combined_datasets.{name}"),
        base_sets=tuple(raw["base_sets"]),
    )


def _eval_set(raw: dict) -> EvalSet:
    return EvalSet(data=raw["data"], split=raw["split"], segment=raw["segment"],
                   augment_num=int(raw.get("augment_num", 0)))


def from_dict(raw: dict) -> Schedule:
    """Validate a parsed schedule JSON into a :class:`Schedule`."""
    try:
        datasets = {
            name: DatasetSpec(name=name,
                              sources=(_source(d, f"datasets.{name}"),),
                              augment_num=_count(d["augment_num"], f"datasets.{name}"))
            for name, d in raw["datasets"].items()
        }
        for name, c in raw.get("combined_datasets", {}).items():
            datasets[name] = _combined(name, c, datasets)

        stages = [Stage(key=s["key"], epochs=int(s["epochs"]),
                        letskip=bool(s.get("letskip", False)))
                  for s in raw["schedule"]]
        unknown = [s.key for s in stages if s.key not in datasets]
        if unknown:
            raise ValueError(f"schedule references unknown dataset '{unknown[0]}'")

        return Schedule(test_set=_eval_set(raw["test_set"]),
                        valid_set=_eval_set(raw["valid_set"]),
                        datasets=datasets, stages=stages)
    except (KeyError, TypeError, ValueError) as exc:
        raise ValueError(f"Invalid schedule: {exc}") from exc


def load_schedule(path: str | Path) -> Schedule:
    return from_dict(json.loads(Path(path).read_text()))
