"""Copy of ``wav2vec_heart_sounds_tpu/train/params.py`` over the port's ``ClassifierConfig``,
held to the original by ``tests/test_torch_imports.py``.

Per-setting classifier hyperparameter presets.

Contract from reference src/mpcg_wav2vec/classify/params.py:14-38: head widths follow the
paper's per-dataset choices (CinC wide 3-layer head; Training-A/vest single hidden layer).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..models.classifier import ClassifierConfig


@dataclass(frozen=True)
class TrainingArgs:
    epochs: int = 20
    optimizer: str = "sgd"
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 64


_MODEL_PRESETS = {
    "cinc": ClassifierConfig(num_classes=2, num_channels=1, head_hidden=(512, 512, 512),
                             fs=16000),
    "training-a": ClassifierConfig(num_classes=2, num_channels=1, head_hidden=(512,), fs=4125),
    "training-a-ecg": ClassifierConfig(num_classes=2, num_channels=1, head_hidden=(128,),
                                       fs=4125),
    "vest": ClassifierConfig(num_classes=2, num_channels=6, head_hidden=(256,), fs=4125),
}


def model_config(setting: str, **overrides) -> ClassifierConfig:
    base = _MODEL_PRESETS.get(setting, ClassifierConfig())
    return replace(base, **overrides) if overrides else base


def training_args(setting: str, **overrides) -> TrainingArgs:
    base = TrainingArgs()
    return replace(base, **overrides) if overrides else base
