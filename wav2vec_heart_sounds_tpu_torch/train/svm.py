"""Copy of ``wav2vec_heart_sounds_tpu/train/svm.py`` (numpy, and sklearn imported at
``fit``), held to the original by ``tests/test_torch_imports.py``. The port's
``encode_fn`` (:func:`.evaluate.make_encode_fn`) returns numpy features.

SVM side-classifier over frozen encoder features (vest ablations).

Contract from reference src/mpcg_wav2vec/classify/svm.py:18-51: collect mean-pooled encoder
features, univariate SelectKBest (k=80), fit sklearn SVC, evaluate via the confusion matrix.
Feature extraction is a device pass; sklearn stays host-side (the card's machine has no
sklearn, so ``fit`` raises ``ImportError`` there).
"""

from __future__ import annotations

import numpy as np

from .metrics import ConfusionMatrix


class NeuralSVM:
    def __init__(self, encode_fn, k_best: int = 80):
        """``encode_fn(x) -> [B, D]`` pooled features (jitted, params closed over)."""
        self.encode_fn = encode_fn
        self.k_best = k_best
        self.selector = None
        self.svm = None

    def _features(self, batcher):
        feats, labels = [], []
        for batch in batcher:
            f = np.asarray(self.encode_fn(batch["waveform"]))
            keep = np.asarray(batch["valid"], dtype=bool)
            feats.append(f[keep])
            labels.extend(int(v) for v, ok in zip(batch["label"], keep) if ok)
        return np.concatenate(feats, axis=0), np.asarray(labels)

    def fit(self, batcher) -> "NeuralSVM":
        from sklearn.feature_selection import SelectKBest
        from sklearn.svm import SVC

        features, labels = self._features(batcher)
        self.selector = SelectKBest(k=min(self.k_best, features.shape[1]))
        selected = self.selector.fit_transform(features, labels)
        self.svm = SVC()
        self.svm.fit(selected, labels)
        return self

    def evaluate(self, batcher) -> dict:
        assert self.svm is not None and self.selector is not None, "call fit() first"
        features, labels = self._features(batcher)
        preds = self.svm.predict(self.selector.transform(features))
        cm = ConfusionMatrix()
        cm.update(labels, preds)
        return cm.stats()
