"""Wav2Vec 2.0 heart-sound classifier (port of ``models/classifier.py``).

Mean-pooled encoder output (float32) feeds a small MLP head whose hidden layers run in the
compute dtype and whose logits layer runs in float32, as in the JAX package. With
``num_channels > 1`` the channels are collapsed by the sinc beamformer
(``channel_mixer``, :mod:`.beamformer`) before the encoder; ``lora`` puts rank-8 adapters
on the encoder's q/v projections (:meth:`ClassifierConfig.encoder_config`).

Freezing follows the JAX package's policy, :func:`trainable_mask`: the trainer gives the
frozen parameters ``requires_grad=False`` and hands only the trainable ones to its
optimizer (:mod:`..train.classifier`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch
from torch import nn

from .beamformer import TimeVaryingSincBeamformer
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

    def encoder_config(self) -> Wav2Vec2Config:
        return replace(self.encoder, lora_rank=8 if self.lora else 0)


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
        self.config = config
        self.encoder = Wav2Vec2Model(config.encoder_config(), dtype)
        if config.num_channels > 1:
            self.channel_mixer = TimeVaryingSincBeamformer(config.num_channels, config.fs,
                                                           dtype=dtype)
        self.head = MLPHead(config.encoder.hidden_size, config.head_hidden,
                            config.num_classes, dtype)

    def encode(self, x: torch.Tensor, train: bool = False,
               generator: torch.Generator | None = None,
               seed: int | None = None) -> torch.Tensor:
        """Mean-pooled encoder features ``[B, hidden]`` (float32) for ``[B, T]`` or
        ``[B, T, C]``; ``seed`` fixes the training step's dropout seed (the fusion model
        shares one across its branches), else the encoder draws it from ``generator``."""
        if x.ndim == 3:
            x = x.transpose(1, 2)                                       # [B, C, T]
        if self.config.num_channels > 1:
            x = self.channel_mixer(x)
        elif x.ndim == 3:
            x = x[:, 0, :] if x.shape[1] == 1 else x.mean(dim=1)
        return self.encoder(x, train, generator, seed).mean(dim=1).float()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; ``train=True`` runs the training forward (dropout, SpecAugment) with its
        randomness drawn from ``generator`` (see ``Wav2Vec2Model.forward``)."""
        return self.head(self.encode(x, train, generator))

    def forward_with_features(self, x: torch.Tensor, train: bool = False,
                              generator: torch.Generator | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(pooled features, logits): the feature-aware loss path (contrastive-focal)."""
        feats = self.encode(x, train, generator)
        return feats, self.head(feats)


def trainable_mask(model: nn.Module, config: ClassifierConfig) -> dict[str, bool]:
    """Parameter name -> trained, the JAX package's freeze/LoRA policy:

    * ``freeze_encoder``: everything under ``encoder`` frozen (head and beamformer train);
    * ``lora`` (and not frozen): the encoder's base frozen, only ``lora_a``/``lora_b`` train;
    * otherwise every parameter trains.
    """
    def decide(name: str) -> bool:
        if not name.startswith("encoder."):
            return True
        if config.freeze_encoder:
            return False
        if config.lora:
            return name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
        return True

    return {name: decide(name) for name, _ in model.named_parameters()}


def apply_trainable_mask(model: nn.Module, config: ClassifierConfig) -> list[nn.Parameter]:
    """Give the frozen parameters of :func:`trainable_mask` ``requires_grad=False`` (so no
    weight gradient is computed for them) and return the trainable ones, in order."""
    mask = trainable_mask(model, config)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return [p for name, p in model.named_parameters() if mask[name]]
