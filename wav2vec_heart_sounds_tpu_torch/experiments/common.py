"""Shared runner helpers (copies of ``make_loader`` and ``append_result`` from
``wav2vec_heart_sounds_tpu/experiments/common.py``, held to the originals by
``tests/test_torch_imports.py``): balanced training loaders and append-only results JSON."""

from __future__ import annotations

import json
from pathlib import Path

from ..data.loader import Batcher


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
