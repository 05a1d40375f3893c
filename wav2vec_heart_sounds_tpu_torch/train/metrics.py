"""Binary classification metrics.

Copy of ``wav2vec_heart_sounds_tpu/train/metrics.py`` (numpy only), held to the original
by ``tests/test_torch_imports.py``.

Reports the paper's exact metric set — accuracy, UAR, sensitivity, specificity, NPV,
precision, F1, MCC (behavior of reference src/mpcg_wav2vec/classify/metrics.py:14-63) —
from a single 2x2 count matrix. The accumulator is vectorised: a batch of (true, pred)
pairs becomes one ``bincount`` over the 4 joint outcomes, and every statistic is derived
from the matrix in one place, so adding a metric is a one-line change.
"""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    """2x2 count matrix ``m[truth, prediction]`` for labels in {0, 1}."""

    __slots__ = ("m",)

    def __init__(self):
        self.m = np.zeros((2, 2), dtype=np.int64)

    def update(self, y_true, y_pred, valid=None) -> None:
        t = np.asarray(y_true, dtype=np.int64).ravel()
        p = np.asarray(y_pred, dtype=np.int64).ravel()
        joint = 2 * t + p                       # 0=TN 1=FP 2=FN 3=TP
        if valid is not None:
            joint = joint[np.asarray(valid, dtype=bool).ravel()]
        self.m += np.bincount(joint, minlength=4).reshape(2, 2)

    # Named cells, for callers and tests that address counts directly.
    @property
    def tn(self) -> int:
        return int(self.m[0, 0])

    @property
    def fp(self) -> int:
        return int(self.m[0, 1])

    @property
    def fn(self) -> int:
        return int(self.m[1, 0])

    @property
    def tp(self) -> int:
        return int(self.m[1, 1])

    @property
    def total(self) -> int:
        return int(self.m.sum())

    def stats(self) -> dict[str, float]:
        m = self.m.astype(np.float64)
        support = m.sum(axis=1)                 # actual negatives / positives
        predicted = m.sum(axis=0)               # predicted negatives / positives
        diag = np.diagonal(m)

        with np.errstate(divide="ignore", invalid="ignore"):
            recall = np.where(support > 0, diag / support, 0.0)       # [spec, sens]
            value = np.where(predicted > 0, diag / predicted, 0.0)    # [npv, precision]
        spec, sens = recall
        npv, prec = value
        f1 = 2.0 * prec * sens / (prec + sens) if (prec + sens) > 0 else 0.0

        det = float(np.linalg.det(m))           # tp*tn - fp*fn
        denom = float(np.sqrt(np.prod(np.concatenate([support, predicted]))))
        return {
            "accuracy": float(diag.sum() / m.sum()) if m.sum() else 0.0,
            "uar": float(recall.mean()),
            "sensitivity": float(sens),
            "specificity": float(spec),
            "npv": float(npv),
            "precision": float(prec),
            "f1": float(f1),
            "mcc": det / denom if denom else 0.0,
        }

    def __str__(self) -> str:
        s = self.stats()
        return (f"acc={s['accuracy']:.4f} uar={s['uar']:.4f} sens={s['sensitivity']:.4f} "
                f"spec={s['specificity']:.4f} mcc={s['mcc']:.4f}")
