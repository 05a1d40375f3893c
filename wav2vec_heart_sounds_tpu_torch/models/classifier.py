"""Wav2Vec 2.0 heart-sound classifier (port of ``models/classifier.py``, single channel).

Mean-pooled encoder output (float32) feeds a small MLP head whose hidden layers run in the
compute dtype and whose logits layer runs in float32, as in the JAX package. Every
parameter trains: LoRA adapters and the frozen encoder come with the vest slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from .wav2vec2 import Wav2Vec2Config, Wav2Vec2Model


@dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 2
    num_channels: int = 1
    head_hidden: tuple[int, ...] = (256,)
    pretrained_name: str = "facebook/wav2vec2-base-960h"
    random_init: bool = False
    lora: bool = False
    freeze_encoder: bool = False
    fs: int = 4125
    encoder: Wav2Vec2Config = field(default_factory=Wav2Vec2Config)


class MLPHead(nn.Module):
    """``relu(dense_i(.))`` stack in the compute dtype, then float32 ``logits``."""

    def __init__(self, in_dim: int, hidden: tuple[int, ...], num_classes: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.hidden = len(hidden)
        for i, width in enumerate(hidden):
            self.add_module(f"dense_{i}", nn.Linear(in_dim, width, dtype=dtype))
            in_dim = width
        self.logits = nn.Linear(in_dim, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for i in range(self.hidden):
            h = torch.relu(getattr(self, f"dense_{i}")(h))
        return self.logits(h.float())


class Wav2VecClassifier(nn.Module):
    def __init__(self, config: ClassifierConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.num_channels > 1:
            raise NotImplementedError(
                "multichannel input (the sinc beamformer) is not ported yet; it comes "
                "with the vest slice")
        if config.lora or config.freeze_encoder:
            raise NotImplementedError(
                "LoRA adapters and the frozen encoder (the optimizer's freeze mask) are not "
                "ported yet; they come with the vest slice")
        self.config = config
        self.encoder = Wav2Vec2Model(config.encoder, dtype)
        self.head = MLPHead(config.encoder.hidden_size, config.head_hidden,
                            config.num_classes, dtype)

    def encode(self, x: torch.Tensor, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Mean-pooled encoder features ``[B, hidden]`` (float32) for ``[B, T]`` or ``[B, T, C]``."""
        if x.ndim == 3:
            x = x[:, :, 0] if x.shape[2] == 1 else x.mean(dim=2)
        return self.encoder(x, train, generator).mean(dim=1).float()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; ``train=True`` runs the training forward (dropout, SpecAugment) with its
        randomness drawn from ``generator`` (see ``Wav2Vec2Model.forward``)."""
        return self.head(self.encode(x, train, generator))
