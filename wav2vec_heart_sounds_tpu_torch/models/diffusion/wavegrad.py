"""WaveGrad: class- and mel-conditioned continuous-noise-level diffusion vocoder (port of
``models/diffusion/wavegrad.py``).

A waveform U-net: down-sampling DBlocks produce FiLM (shift, scale) pairs (with the class
label injected in the FiLM), up-sampling UBlocks decode from the mel conditioner under those
modulations, factors 5/5/3/2/2 whose product is the hop (300). The channel widths are fixed
class attributes, so every WaveGrad has the same 15,956,161 parameters. Channels-first
``[B, C, T]`` throughout.

The resizes are ``jax.image.resize(method="nearest")``, which on a down-sampling resize (the
DBlocks' ``T // factor``) is torch's ``mode="nearest-exact"``, not its default
``mode="nearest"`` (a wrong WaveGrad that still runs); ``tests/test_torch_diffusion.py``
holds the choice. The conditioner is cropped to ``audio_len // hop`` frames. At a bf16
``dtype`` the parameters stay float32 and each layer casts at use (:mod:`.layers`), as the
JAX module's ``dtype=``; ``last_conv`` computes in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .init import EMBED, ORTHOGONAL, XAVIER_UNIFORM, init_parameters, tagged
from .layers import Conv1d, Embedding, Linear, set_compute_dtype
from .schedules import NoiseSchedule, noise_level_encoding


@dataclass(frozen=True)
class WaveGradConfig:
    sample_rate: int = 4000
    n_mels: int = 128
    hop_length: int = 300
    num_classes: int = 2
    label_dim: int = 32
    train_beta: tuple[float, float, int] = (1e-6, 0.01, 1000)

    def training_schedule(self) -> NoiseSchedule:
        return NoiseSchedule.linear(*self.train_beta)


def _resize(x: torch.Tensor, length: int) -> torch.Tensor:
    """Nearest-neighbour resize of [B, C, T] along time (``jax.image.resize`` "nearest")."""
    return F.interpolate(x, size=length, mode="nearest-exact")


def _conv(cin: int, cout: int, kernel: int, dilation: int = 1,
          kind: str = ORTHOGONAL) -> Conv1d:
    pad = dilation * (kernel - 1) // 2
    return tagged(Conv1d(cin, cout, kernel, padding=pad, dilation=dilation), kind)


class FiLM(nn.Module):
    """(features, noise level, label) -> (shift, scale) modulations."""

    def __init__(self, in_ch: int, out_ch: int, num_classes: int, label_dim: int):
        super().__init__()
        self.label_embedding = tagged(Embedding(num_classes, label_dim), EMBED)
        self.label_proj = tagged(Linear(label_dim, in_ch), XAVIER_UNIFORM)
        self.input_conv = _conv(in_ch, in_ch, 3, kind=XAVIER_UNIFORM)
        self.output_conv = _conv(in_ch, 2 * out_ch, 3, kind=XAVIER_UNIFORM)

    def forward(self, x, noise_level, label):
        label_feat = self.label_proj(self.label_embedding(label))
        x = self.input_conv(x + label_feat[:, :, None])
        x = noise_level_encoding(F.leaky_relu(x, 0.2), noise_level)
        shift, scale = torch.chunk(self.output_conv(x), 2, dim=1)
        return shift, scale


class DBlock(nn.Module):
    """Down-sampling residual block."""

    def __init__(self, in_ch: int, out_ch: int, factor: int):
        super().__init__()
        self.factor = factor
        self.residual = _conv(in_ch, out_ch, 1)
        self.convs = nn.ModuleList(_conv(in_ch if i == 0 else out_ch, out_ch, 3, dil)
                                   for i, dil in enumerate((1, 2, 4)))

    def forward(self, x):
        size = x.shape[-1] // self.factor
        residual = _resize(self.residual(x), size)
        x = _resize(x, size)
        for conv in self.convs:
            x = conv(F.leaky_relu(x, 0.2))
        return x + residual


class UBlock(nn.Module):
    """Up-sampling residual block modulated by FiLM (shift, scale)."""

    def __init__(self, in_ch: int, out_ch: int, factor: int, dilations: tuple[int, ...]):
        super().__init__()
        self.factor = factor
        self.skip = _conv(in_ch, out_ch, 1)
        self.conv_a0 = _conv(in_ch, out_ch, 3, dilations[0])
        self.conv_a1 = _conv(out_ch, out_ch, 3, dilations[1])
        self.conv_b0 = _conv(out_ch, out_ch, 3, dilations[2])
        self.conv_b1 = _conv(out_ch, out_ch, 3, dilations[3])

    def forward(self, x, shift, scale):
        size = x.shape[-1] * self.factor
        skip = self.skip(_resize(x, size))
        h = self.conv_a0(_resize(F.leaky_relu(x, 0.2), size))
        h = self.conv_a1(F.leaky_relu(shift + scale * h, 0.2))
        x = skip + h
        h = self.conv_b0(F.leaky_relu(shift + scale * x, 0.2))
        h = self.conv_b1(F.leaky_relu(shift + scale * h, 0.2))
        return x + h


class WaveGrad(nn.Module):
    _down = ((128, 2), (128, 2), (256, 3), (512, 5))
    _film = ((32, 128), (128, 128), (128, 256), (256, 512), (512, 512))
    _up = ((512, 5, (1, 2, 1, 2)), (512, 5, (1, 2, 1, 2)), (256, 3, (1, 2, 4, 8)),
           (128, 2, (1, 2, 4, 8)), (128, 2, (1, 2, 4, 8)))
    _init_ch, _first_ch = 32, 768

    def __init__(self, config: WaveGradConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.init_conv = _conv(1, self._init_ch, 5)
        ins = [self._init_ch] + [ch for ch, _ in self._down[:-1]]
        self.downs = nn.ModuleList(DBlock(cin, ch, f) for cin, (ch, f) in zip(ins, self._down))
        self.films = nn.ModuleList(FiLM(cin, cout, cfg.num_classes, cfg.label_dim)
                                   for cin, cout in self._film)
        self.first_conv = _conv(cfg.n_mels, self._first_ch, 3)
        ins = [self._first_ch] + [ch for ch, _, _ in self._up[:-1]]
        self.ups = nn.ModuleList(UBlock(cin, ch, f, dils)
                                 for cin, (ch, f, dils) in zip(ins, self._up))
        self.last_conv = _conv(self._up[-1][0], 1, 3)
        set_compute_dtype(self, dtype, (self.last_conv,))

    def forward(self, audio: torch.Tensor, conditioner: torch.Tensor,
                noise_level: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """audio [B, T], conditioner [B, n_mels, frames], noise_level [B], label [B] -> [B, T]."""
        x = self.init_conv(audio[:, None])
        stages = [x]
        for block in self.downs:
            x = block(x)
            stages.append(x)
        modulations = [film(feat, noise_level, label) for film, feat in zip(self.films, stages)]

        # Keep exactly audio_len / hop mel frames so the upsample path matches the audio.
        frames = audio.shape[-1] // self.config.hop_length
        h = self.first_conv(conditioner[:, :, :frames])
        for block, (shift, scale) in zip(self.ups, reversed(modulations)):
            h = block(h, shift, scale)
        return self.last_conv(h)[:, 0]


def build_wavegrad(config: WaveGradConfig = WaveGradConfig(), seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> WaveGrad:
    """A seeded WaveGrad on ``device`` (the card unless the caller asks for the CPU),
    computing in ``dtype`` with float32 parameters."""
    model = WaveGrad(config, dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)
