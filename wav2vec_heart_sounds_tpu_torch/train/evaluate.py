"""Fragment-level and patient-level evaluation (port of ``train/evaluate.py``).

Every window is scored on its own (fragment level); each patient's fragment logits are
averaged and the softmax of the mean decides one verdict per patient (patient level, the
paper's reporting granularity). The forward runs on the card under
``torch.inference_mode``; the patient aggregation is a small host pass in numpy.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..config import WIRE_SCALE
from ..utils.observe import gathered, span
from .metrics import ConfusionMatrix


def _softmax(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max())
    return e / e.sum()


def _host(logits) -> np.ndarray:
    if isinstance(logits, torch.Tensor):
        return logits.detach().float().cpu().numpy()
    return np.asarray(logits)


def evaluate(apply_fn, batcher, max_batches: int | None = None) -> dict:
    """``apply_fn(x) -> logits`` for each batch of ``batcher``; fragment and patient stats.

    While a profiler records, each ``next()`` on ``batcher`` is a ``batch.gather`` span that
    starts the batch's serial, and the host's count of a batch's logits (argmax, the
    confusion matrix, the per-window patient loop) a ``score.tally`` span."""
    fragment_cm = ConfusionMatrix()
    patient_logits: dict[str, list[np.ndarray]] = defaultdict(list)
    patient_true: dict[str, int] = {}

    for i, (_, batch) in enumerate(gathered(batcher)):
        if max_batches is not None and i >= max_batches:
            break
        logits = _host(apply_fn(batch["waveform"]))
        with span("score.tally"):
            preds = logits.argmax(axis=1)
            fragment_cm.update(batch["label"], preds, batch["valid"])
            for j, patient in enumerate(batch["patient"]):
                if not batch["valid"][j]:
                    continue
                patient_logits[patient].append(logits[j])
                patient_true[patient] = int(batch["label"][j])

    patient_cm = ConfusionMatrix()
    for patient, logit_list in patient_logits.items():
        mean_prob = _softmax(np.stack(logit_list).mean(axis=0))
        patient_cm.update([patient_true[patient]], [int(np.argmax(mean_prob))])

    return {"fragment": fragment_cm.stats(), "patient": patient_cm.stats()}


def dequant(x: torch.Tensor) -> torch.Tensor:
    """int16 wire -> float32 in [-1, 1]; float input passes through."""
    if not torch.is_floating_point(x):
        return x.float() * (1.0 / WIRE_SCALE)
    return x


def make_apply_fn(model: torch.nn.Module):
    """Logits function: host or device batch -> model's device -> dequantise -> forward."""
    device = next(model.parameters()).device

    def apply_fn(x) -> torch.Tensor:
        with torch.inference_mode():
            return model(dequant(torch.as_tensor(x).to(device)))

    return apply_fn


def make_encode_fn(model: torch.nn.Module):
    """Pooled-feature function for the SVM probe: host or device batch -> numpy ``[B, D]``
    (``model.encode``)."""
    device = next(model.parameters()).device

    def encode_fn(x) -> np.ndarray:
        with torch.inference_mode():
            feats = model.encode(dequant(torch.as_tensor(x).to(device)))
        return feats.float().cpu().numpy()

    return encode_fn
