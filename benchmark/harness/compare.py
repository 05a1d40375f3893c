"""The comparison that decides ``correct``: readings of the program against the reference,
each held to its limit from the cell file.

Training (three checked steps, the window's own loop): the largest relative gap of a
step's loss; the gap between the program's and the reference's norms of each leaf's first
clipped gradient and of each leaf's change after the last step, each over the reference's
norm of that leaf or of the median leaf, whichever is larger, of the median leaf (the
worst leaf's, a small leaf's bf16 noise, is reported beside it); the largest absolute gap
of the preprocessed windows. Leaves whose first reference gradient is under a thousandth of
the median leaf's are left out of the two norm gaps (their gradient is rounding: the key
biases under softmax).

Scoring (a seeded sample of the windows scored in the window): the largest absolute gap of
the preprocessed windows; the largest logit gap over the reference's largest logit; the
largest gap of a sampled patient's verdict probability (the softmax of the mean of its
windows' logits); and, exactly, whether each pass's fragment and patient verdicts agree with
the program's own logits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEGLIGIBLE = 1e-3          # of the median leaf's first reference gradient norm


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tensors.items()}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep: list[str]) -> dict:
    """Each kept leaf's gap between the program's and the reference's norms, relative to
    that leaf's reference norm or the median kept leaf's, whichever is larger."""
    median = float(np.median([ref[n] for n in keep]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep}


def kept_leaves(ref_grad: dict[str, float]) -> list[str]:
    median = float(np.median(list(ref_grad.values())))
    return [n for n, v in ref_grad.items() if v >= NEGLIGIBLE * median]


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``losses`` [steps], ``grad`` and ``delta`` leaf norms; ``prep_gap``
    only on ``prog`` (worked out by the caller against the reference chain). The norm gaps
    compared are the median leaf's; the worst leaf's go under ``_worst``."""
    keep = kept_leaves(ref["grad"])
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))}
    worst = {"losses": [prog["losses"], ref["losses"]], "left_out": len(ref["grad"]) - len(keep),
             "grad_norm": [math.sqrt(sum(v * v for v in side["grad"].values()))
                           for side in (prog, ref)]}
    for key, name in (("grad", "grad_gap_median_leaf"), ("delta", "update_gap_median_leaf")):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        out[name] = float(np.median(list(gaps.values())))
        leaf = max(gaps, key=gaps.get)
        worst[key] = [leaf, gaps[leaf], prog[key][leaf], ref[key][leaf]]
    return {**out, "prep_gap": prog["prep_gap"], "_worst": worst}


def patient_probabilities(logits: np.ndarray, patients: np.ndarray) -> dict[int, float]:
    """Each patient's verdict probability of class 1: softmax of its mean logits."""
    out = {}
    for p in np.unique(patients):
        z = logits[patients == p].astype(np.float64).mean(axis=0)
        e = np.exp(z - z.max())
        out[int(p)] = float(e[1] / e.sum())
    return out


def verdict_counts(logits: np.ndarray, labels: np.ndarray, patients: np.ndarray) -> dict:
    """(true positives, true negatives) of the fragments and of the patients."""
    preds = logits.argmax(axis=1)
    out = {"fragment": (int(((preds == 1) & (labels == 1)).sum()),
                        int(((preds == 0) & (labels == 0)).sum()))}
    tp = tn = 0
    for p in np.unique(patients):
        rows = patients == p
        pred = int(logits[rows].astype(np.float64).mean(axis=0).argmax())
        label = int(labels[rows][0])
        tp += pred == 1 and label == 1
        tn += pred == 0 and label == 0
    out["patient"] = (tp, tn)
    return out


def counts_of(stats: dict, labels: np.ndarray) -> tuple[int, int]:
    """(true positives, true negatives) behind the program's ``sensitivity`` and
    ``specificity`` over items with ``labels``."""
    return (int(round(stats["sensitivity"] * int((labels == 1).sum()))),
            int(round(stats["specificity"] * int((labels == 0).sum()))))


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every limited reading; a reading without a
    limit, or one that is not finite, is not correct."""
    checks, ok = {}, True
    for name, value in readings.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        finite = math.isfinite(value)
        checks[name] = {"value": value if finite else str(value), "limit": limit}
        if limit is None or not finite or value > limit:
            ok = False
    return ok, checks
