"""Per-epoch scalar logging: copy of ``ScalarLogger`` from
``wav2vec_heart_sounds_tpu/utils/observe.py``, held to the original by
``tests/test_torch_imports.py``. JSONL rows in ``<log_dir>/scalars.jsonl``, mirrored to
TensorBoard when its writer imports. The profiler hook (``trace``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import time


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
