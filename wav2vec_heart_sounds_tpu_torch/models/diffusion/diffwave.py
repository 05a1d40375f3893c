"""DiffWave: class- and mel-conditioned discrete-step DDPM vocoder (port of
``models/diffusion/diffwave.py``).

A 1x1 in-projection, 30 gated dilated residual blocks (dilation 2^(i mod 10), 64 channels;
each conditioned on the diffusion-step embedding, the transposed-conv-upsampled mel and a
class-label embedding), the summed skips over sqrt(L), and a zero-init float32
out-projection predicting epsilon. Channels-first ``[B, C, T]`` throughout, so the dilated
convs are ``nn.Conv1d`` and the flax ``Dense`` layers over channels are 1x1 convs.

The mel upsampler is ``nn.ConvTranspose2d(1, 1, (3, 2f), stride (1, f), padding
(1, f // 2))`` per factor, each followed by ``leaky_relu(0.4)``: the JAX module's
``conv_transpose2d_torchlike`` flips the flax kernel ``(3, 2f, 1, 1)`` itself, so torch's
weight ``[1, 1, 3, 2f]`` is that kernel unflipped (:mod:`..from_jax`). An odd factor gives
``W f + 1`` columns, which :func:`_match_time` crops.

:func:`build_diffwave` makes the model from a seed on ``device``, computing in ``dtype`` as the
JAX module built with ``dtype=`` does: every parameter and buffer stays float32, each layer
casts its weight and its input to ``dtype`` where it computes (:mod:`.layers`), and the
out-projection computes in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import sqrt

import torch
import torch.nn.functional as F
from torch import nn

from .init import EMBED, HE_NORMAL, LECUN_NORMAL, ZEROS, init_parameters, tagged
from .layers import Conv1d, ConvTranspose2d, Embedding, Linear, set_compute_dtype
from .schedules import DiffusionStepEmbedding, NoiseSchedule


@dataclass(frozen=True)
class DiffWaveConfig:
    sample_rate: int = 4000
    n_mels: int = 80
    n_fft: int = 1024
    hop_length: int = 256
    residual_layers: int = 30
    residual_channels: int = 64
    dilation_cycle: int = 10
    step_hidden: int = 512
    num_classes: int = 2
    label_dim: int = 32
    train_beta: tuple[float, float, int] = (1e-4, 0.05, 50)
    inference_betas: tuple = (0.0001, 0.001, 0.01, 0.05, 0.2, 0.5)

    def training_schedule(self) -> NoiseSchedule:
        return NoiseSchedule.linear(*self.train_beta)

    def upsample_factors(self) -> tuple[int, int]:
        """Two transposed-conv strides whose product equals the hop length."""
        hop = self.hop_length
        for a in range(int(sqrt(hop)), 0, -1):
            if hop % a == 0:
                return a, hop // a
        return 1, hop


def _dense(cin: int, cout: int, kind: str = HE_NORMAL) -> Conv1d:
    """A flax ``Dense`` over the channels of ``[B, C, T]``: a 1x1 conv."""
    return tagged(Conv1d(cin, cout, 1), kind)


class MelUpsampler(nn.Module):
    """[B, n_mels, frames] -> [B, n_mels, frames * hop (+1 per odd factor)]."""

    def __init__(self, factors: tuple[int, int]):
        super().__init__()
        self.convs = nn.ModuleList(
            tagged(ConvTranspose2d(1, 1, (3, 2 * f), stride=(1, f), padding=(1, f // 2)),
                   LECUN_NORMAL) for f in factors)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel[:, None]                                           # [B, 1, M, F]
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.4)
        return x[:, 0]


def _match_time(x: torch.Tensor, length: int) -> torch.Tensor:
    """Crop or zero-pad ``[B, C, T]`` along time to exactly ``length``."""
    if x.shape[-1] > length:
        return x[..., :length]
    if x.shape[-1] < length:
        return F.pad(x, (0, length - x.shape[-1]))
    return x


class ResidualBlock(nn.Module):
    def __init__(self, n_mels: int, channels: int, dilation: int, step_hidden: int,
                 label_dim: int):
        super().__init__()
        c, d = channels, dilation
        self.step_proj = tagged(Linear(step_hidden, c), LECUN_NORMAL)
        self.dilated = tagged(Conv1d(c, 2 * c, 3, padding=d, dilation=d), HE_NORMAL)
        self.cond_proj = _dense(n_mels, 2 * c)
        self.label_proj = tagged(Linear(label_dim, 2 * c), HE_NORMAL)
        self.out_proj = _dense(c, 2 * c)

    def forward(self, x, step_embed, conditioner, label_embed):
        y = x + self.step_proj(step_embed)[:, :, None]
        y = self.dilated(y)
        y = y + self.cond_proj(conditioner)
        y = y + self.label_proj(label_embed)[:, :, None]
        gate, filt = torch.chunk(y, 2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        residual, skip = torch.chunk(self.out_proj(y), 2, dim=1)
        return (x + residual) / sqrt(2.0), skip


class DiffWave(nn.Module):
    def __init__(self, config: DiffWaveConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        c = cfg.residual_channels
        self.input_projection = _dense(1, c)
        self.step_embedding = DiffusionStepEmbedding(len(cfg.training_schedule()),
                                                     hidden=cfg.step_hidden)
        for layer in (self.step_embedding.proj1, self.step_embedding.proj2):
            tagged(layer, LECUN_NORMAL)
        self.mel_upsampler = MelUpsampler(cfg.upsample_factors())
        self.label_embedding = tagged(Embedding(cfg.num_classes, cfg.label_dim), EMBED)
        self.residual_layers = nn.ModuleList(
            ResidualBlock(cfg.n_mels, c, 2 ** (i % cfg.dilation_cycle), cfg.step_hidden,
                          cfg.label_dim) for i in range(cfg.residual_layers))
        self.skip_projection = _dense(c, c)
        self.output_projection = _dense(c, 1, ZEROS)
        set_compute_dtype(self, dtype, (self.output_projection,))

    def forward(self, audio: torch.Tensor, step: torch.Tensor, conditioner: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
        """audio [B, T], step [B], conditioner [B, n_mels, frames], label [B] -> eps [B, T]."""
        x = F.relu(self.input_projection(audio[:, None]))
        step_embed = self.step_embedding(step)
        cond = _match_time(self.mel_upsampler(conditioner), x.shape[-1])
        label_embed = self.label_embedding(label)
        skip = 0.0
        for block in self.residual_layers:
            x, s = block(x, step_embed, cond, label_embed)
            skip = skip + s
        x = skip / sqrt(self.config.residual_layers)
        x = F.relu(self.skip_projection(x))
        return self.output_projection(x)[:, 0]


def build_diffwave(config: DiffWaveConfig = DiffWaveConfig(), seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> DiffWave:
    """A seeded DiffWave on ``device`` (the card unless the caller asks for the CPU),
    computing in ``dtype`` with float32 parameters."""
    model = DiffWave(config, dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
