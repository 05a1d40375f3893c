"""CinC PCG scoring path (port of the test-split half of ``experiments/cinc.py::run``).

Under the raw wire, the JAX runner scores the test split as: eval ``Batcher`` of raw
low-rate windows -> on-device PCG preprocessing -> crop to ``win_len`` -> classifier ->
fragment and patient statistics (``experiments/cinc.py:134-181``). :func:`score` is that
path as one call. Training and the CLI are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..signal.torchproc import preprocess_pcg
from ..train.evaluate import dequant, evaluate, make_apply_fn


def _device_prep(fs_wire: int, fs: int, win_len: int, device):
    """Dequantise + PCG preprocessing on ``device`` + crop to ``win_len``."""

    def prep(x) -> torch.Tensor:
        x = dequant(torch.as_tensor(x).to(device))
        return preprocess_pcg(x, fs_wire, fs)[:, :win_len]

    return prep


def score(model: torch.nn.Module, batcher, fs_wire: int, fs: int, win_len: int,
          max_batches: int | None = None) -> dict:
    """Score every batch of raw ``fs_wire`` windows with ``model`` at ``fs``.

    Returns the fragment and patient statistics of :func:`..train.evaluate.evaluate`, plus
    ``logits``: float32 ``[n_batches * batch_size, num_classes]``, every row of every
    batch in order (the padded rows of an eval batcher's last batch included).
    """
    device = next(model.parameters()).device
    prep = _device_prep(fs_wire, fs, win_len, device)
    apply = make_apply_fn(model)
    logits: list[np.ndarray] = []

    def apply_fn(x) -> np.ndarray:
        with torch.inference_mode():
            out = apply(prep(x)).float().cpu().numpy()
        logits.append(out)
        return out

    metrics = evaluate(apply_fn, batcher, max_batches)
    return {**metrics, "logits": np.concatenate(logits)}
