"""Shared runner helpers (copies of ``make_loader`` and ``append_result`` from
``wav2vec_heart_sounds_tpu/experiments/common.py``, held to the originals by
``tests/test_torch_imports.py``): balanced training loaders and append-only results JSON;
and :func:`write_result`, which appends from rank 0 only under a data-parallel mesh."""

from __future__ import annotations

import json
from pathlib import Path

from ..data.loader import Batcher
from ..parallel.mesh import is_main


def make_loader(dataset, batch_size: int, train: bool, seed: int = 0,
                target_len: int | None = None) -> Batcher:
    # Training batches ship int16 over the host->device link; the trainer dequantises on
    # the device. Eval loaders stay float32 (their batches feed plain apply fns).
    return Batcher(dataset, batch_size, train, seed=seed, target_len=target_len,
                   wire_int16=train)


def append_result(results_json: str | None, record: dict) -> None:
    if not results_json:
        return
    path = Path(results_json)
    path.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(path.read_text()) if path.exists() else []
    existing.append(record)
    path.write_text(json.dumps(existing, indent=2, default=str))


def write_result(results_json: str | None, record: dict, mesh=None) -> None:
    """:func:`append_result` by rank 0 of ``mesh`` (by the one process without a mesh)."""
    if is_main(mesh):
        append_result(results_json, record)
