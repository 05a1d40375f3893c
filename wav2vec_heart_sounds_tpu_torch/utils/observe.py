"""Observability (port of ``wav2vec_heart_sounds_tpu/utils/observe.py``): per-epoch scalar
logging, a profiler hook and a stopwatch.

``ScalarLogger`` and ``stopwatch`` are copies, held to the originals by
``tests/test_torch_imports.py``: JSONL rows in ``<log_dir>/scalars.jsonl``, mirrored to
TensorBoard when its writer imports. :func:`trace` takes the ``jax.profiler`` trace's place
with ``torch.profiler``: host activity, and the card's kernels when there is a card.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import torch


class ScalarLogger:
    """Append-only scalar sink: ``scalars.jsonl`` rows + optional TensorBoard mirror."""

    def __init__(self, log_dir: str | None):
        self.log_dir = log_dir
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard.writer import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.log_dir:
            return
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as fh:
            fh.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                 "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, prefix: str, values: dict[str, float], step: int) -> None:
        for name, value in values.items():
            self.scalar(f"{prefix}/{name}", value, step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()


@contextlib.contextmanager
def trace(log_dir: str | None, label: str = "trace") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region as a Chrome trace,
    ``<log_dir>/<label>/trace.json`` (no-op without a log_dir)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    try:
        yield
    finally:
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(path, "trace.json"))


@contextlib.contextmanager
def stopwatch(sink: dict, key: str) -> Iterator[None]:
    """Accumulate wall time of the enclosed region into ``sink[key]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink[key] = sink.get(key, 0.0) + time.perf_counter() - t0
