"""Diffusion noise schedules and conditioning embeddings, shared by both vocoders (port of
``models/diffusion/schedules.py``).

:class:`NoiseSchedule` and :func:`step_embedding_table` are numpy copies of the originals
(``tests/test_torch_imports.py``). :class:`DiffusionStepEmbedding` gathers the sinusoidal
table at an integer step (training) and interpolates between ``floor`` and ``ceil`` at a
float step (the fast sampler's fractional steps), branching on the step tensor's dtype as the
JAX module does; then a SiLU MLP. :func:`noise_level_encoding` is WaveGrad's Fourier
encoding of a continuous noise level, here on channels-first ``[B, C, T]`` features.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import log

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


@dataclass(frozen=True)
class NoiseSchedule:
    betas: tuple[float, ...]

    @classmethod
    def linear(cls, start: float, end: float, steps: int) -> "NoiseSchedule":
        return cls(tuple(np.linspace(start, end, steps, dtype=np.float64)))

    def __len__(self) -> int:
        return len(self.betas)

    @property
    def alphas(self) -> np.ndarray:
        return 1.0 - np.asarray(self.betas)

    @property
    def alpha_cumprod(self) -> np.ndarray:
        return np.cumprod(self.alphas)

    def training_noise_levels(self) -> np.ndarray:
        """cumprod(1-beta): signal variance retained at each discrete step (DiffWave)."""
        return self.alpha_cumprod

    def continuous_noise_levels(self) -> np.ndarray:
        """sqrt(cumprod(1-beta)) prefixed with 1.0 (WaveGrad continuous lookup)."""
        return np.concatenate([[1.0], np.sqrt(self.alpha_cumprod)])


def step_embedding_table(num_steps: int, dim: int = 128,
                         max_freq_exp: float = 4.0) -> np.ndarray:
    """Sinusoidal embedding of integer steps -> ``[num_steps, dim]`` (host-built constant)."""
    half = dim // 2
    freqs = 10.0 ** (np.arange(half) * max_freq_exp / (half - 1))
    args = np.arange(num_steps)[:, None] * freqs[None, :]
    return np.concatenate([np.sin(args), np.cos(args)], axis=-1).astype(np.float32)


class DiffusionStepEmbedding(nn.Module):
    """Step table + SiLU MLP with fractional-step interpolation (fast sampling)."""

    def __init__(self, num_steps: int, dim: int = 128, hidden: int = 512):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(step_embedding_table(num_steps, dim)),
                             persistent=False)
        self.proj1 = Linear(dim, hidden)
        self.proj2 = Linear(hidden, hidden)

    def forward(self, step: torch.Tensor) -> torch.Tensor:
        table = self.table
        if not torch.is_floating_point(step):
            x = table[step]
        else:
            lo = torch.floor(step).long()
            hi = torch.ceil(step).long()
            frac = (step - lo)[..., None]
            x = table[lo] + (table[hi] - table[lo]) * frac
        x = F.silu(self.proj1(x))
        return F.silu(self.proj2(x))


def noise_level_encoding(x: torch.Tensor, noise_level: torch.Tensor) -> torch.Tensor:
    """Add a Fourier encoding of a continuous noise level to ``[B, C, T]`` features."""
    channels = x.shape[1]
    half = channels // 2
    steps = torch.arange(half, dtype=x.dtype, device=x.device) / half
    enc = noise_level[:, None].to(x.dtype) * torch.exp(-log(1e4) * steps)[None, :]
    enc = torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)
    return x + enc[:, :, None]
