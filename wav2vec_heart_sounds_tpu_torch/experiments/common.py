"""Shared runner helpers (copy of ``make_loader`` from
``wav2vec_heart_sounds_tpu/experiments/common.py``, held to the original by
``tests/test_torch_imports.py``)."""

from __future__ import annotations

from ..data.loader import Batcher


def make_loader(dataset, batch_size: int, train: bool, seed: int = 0,
                target_len: int | None = None) -> Batcher:
    # Training batches ship int16 over the host->device link; the trainer dequantises on
    # the device. Eval loaders stay float32 (their batches feed plain apply fns).
    return Batcher(dataset, batch_size, train, seed=seed, target_len=target_len,
                   wire_int16=train)
