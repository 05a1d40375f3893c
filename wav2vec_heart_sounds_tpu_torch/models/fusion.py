"""Per-channel encoder fusion: the two-branch PCG+ECG ``big_rnn:2:wav2vec`` model (port of
``models/fusion.py``).

Each input channel ``x[:, :, i]`` goes through its own branch classifier's ``encode`` (a
full :class:`.classifier.Wav2VecClassifier`; its own head is kept, so the parameter tree is
the JAX package's, but unused); the mean-pooled 768-d features are concatenated, 2 x 768,
and :class:`FusionHead` classifies them: dense 256 -> relu -> dense 128 -> relu -> float32
logits. The head computes in float32 unless asked otherwise, as the JAX package's
``two_branch_pcg_ecg`` builds it. Every parameter trains, branches included.

Randomness in training, as the JAX package's ``EncoderFusion.encode`` (``fusion.py:64-72``):
both branches get the same dropout rngs and have identical module paths, so their dropout
keys are the same; the SpecAugment key of branch ``i`` is ``fold_in(mask_key, i)``. In the
port the forward draws one step seed from the generator and hands it to every branch, so
both branches draw their Philox masks from the same (seed, site) pairs, then each branch
draws its own SpecAugment spans from the generator in turn.
"""

from __future__ import annotations

import torch
from torch import nn

from .classifier import MLPHead, Wav2VecClassifier
from .wav2vec2 import init_parameters, step_seed


class FusionHead(MLPHead):
    """``relu(dense_0)`` (2 h) -> ``relu(dense_1)`` (h) -> float32 ``logits``."""

    def __init__(self, in_dim: int, num_classes: int = 2, hidden: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, (2 * hidden, hidden), num_classes, dtype)


class EncoderFusion(nn.Module):
    """N branch classifiers (``branch_0`` ... ) and a :class:`FusionHead` over their
    concatenated pooled features; ``[B, T, N]`` in, one channel per branch."""

    def __init__(self, branches: list[Wav2VecClassifier], num_classes: int = 2,
                 hidden: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_branches = len(branches)
        for i, branch in enumerate(branches):
            self.add_module(f"branch_{i}", branch)
        self.feature_dim = sum(b.config.encoder.hidden_size for b in branches)
        self.head = FusionHead(self.feature_dim, num_classes, hidden, dtype)

    def branches(self) -> list[Wav2VecClassifier]:
        return [getattr(self, f"branch_{i}") for i in range(self.num_branches)]

    def encode(self, x: torch.Tensor, train: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """``x [B, T, N]`` -> the branches' pooled features concatenated, float32."""
        if x.ndim != 3 or x.shape[2] != self.num_branches:
            raise ValueError(f"Expected [B, T, {self.num_branches}] input, got {tuple(x.shape)}")
        seed = step_seed(generator) if train else None
        return torch.cat([branch.encode(x[:, :, i], train, generator, seed)
                          for i, branch in enumerate(self.branches())], dim=1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.head(self.encode(x, train, generator))

    def forward_with_features(self, x: torch.Tensor, train: bool = False,
                              generator: torch.Generator | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        feats = self.encode(x, train, generator)
        return feats, self.head(feats)


def two_branch_pcg_ecg(pcg_branch: Wav2VecClassifier, ecg_branch: Wav2VecClassifier,
                       num_classes: int = 2, seed: int = 0) -> EncoderFusion:
    """The fusion model over two trained branches (PCG on channel 0, ECG on channel 1),
    with a fresh float32 head initialised from ``seed`` on the branches' device, in the
    branches' train/eval mode."""
    with torch.device(next(pcg_branch.parameters()).device):
        fusion = EncoderFusion([pcg_branch, ecg_branch], num_classes)
    init_parameters(fusion.head, torch.Generator().manual_seed(seed))
    return fusion.train(pcg_branch.training)
