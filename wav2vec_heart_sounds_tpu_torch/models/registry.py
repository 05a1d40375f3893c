"""Generator registry: name -> model builder, loss strategy, sampler, conditioning mel (port
of ``models/registry.py``).

The paper's generator constants: DiffWave mel n_fft 1024 / hop 256 / 80 mels; WaveGrad win
1200 / n_fft next-pow2 (2048) / hop 300 / 128 mels; ``f_max`` 500 Hz for PCG vs 200 Hz for
ECG conditioning; both at 4 kHz, 96 conditioning frames. :class:`MelRecipe` is a copy of the
original. ``build_model(num_classes, seed=0, device="cuda", dtype=torch.float32)`` returns a
seeded model (the JAX builder returns an uninitialised flax module); ``sample`` is
``(model, conditioner, label, generator, **kw)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..signal.spectrogram import MelConfig
from .diffusion.diffwave import DiffWaveConfig, build_diffwave
from .diffusion.samplers import diffwave_sample, wavegrad_sample
from .diffusion.wavegrad import WaveGradConfig, build_wavegrad

GENERATIVE_FS = 4000
CONDITIONING_F_MAX = {"ecg": 200.0, "pcg": 500.0, "pcg_ref": 500.0}


@dataclass(frozen=True)
class MelRecipe:
    """Conditioning-mel settings; ``f_max`` resolves per conditioning signal."""

    n_mels: int
    hop_length: int
    win_length: int | None = None

    def config(self, signal: str) -> MelConfig:
        win = self.win_length or 0
        n_fft = 1 << (max(win, 4 * self.hop_length - 1) - 1).bit_length() \
            if self.win_length else 1024
        kw = {"win_length": win} if self.win_length else {}
        return MelConfig(sample_rate=GENERATIVE_FS, n_fft=n_fft,
                         hop_length=self.hop_length, n_mels=self.n_mels,
                         f_max=CONDITIONING_F_MAX.get(signal, 500.0), **kw)


@dataclass
class GeneratorSpec:
    build_model: Callable                # (num_classes, seed=0, device=..., dtype=...)
    loss: Callable                       # train.generative loss strategy
    sample: Callable                     # (model, conditioner, label, generator, **kw)
    mel: Callable[[str], MelConfig]
    sample_rate: int
    hop_length: int
    crop_frames: int


def _registry() -> dict[str, GeneratorSpec]:
    from ..train.generative import diffwave_loss, wavegrad_loss

    diffwave_recipe = MelRecipe(n_mels=80, hop_length=256)
    wavegrad_recipe = MelRecipe(n_mels=128, hop_length=300, win_length=1200)
    return {
        "diffwave": GeneratorSpec(
            build_model=lambda num_classes, **kw: build_diffwave(
                DiffWaveConfig(num_classes=num_classes), **kw),
            loss=diffwave_loss, sample=diffwave_sample, mel=diffwave_recipe.config,
            sample_rate=GENERATIVE_FS, hop_length=256, crop_frames=96),
        "wavegrad": GeneratorSpec(
            build_model=lambda num_classes, **kw: build_wavegrad(
                WaveGradConfig(num_classes=num_classes), **kw),
            loss=wavegrad_loss, sample=wavegrad_sample, mel=wavegrad_recipe.config,
            sample_rate=GENERATIVE_FS, hop_length=300, crop_frames=96),
    }


def get_spec(name: str) -> GeneratorSpec:
    registry = _registry()
    key = name.lower()
    if key not in registry:
        raise ValueError(f"Unknown generator '{name}'. Options: {sorted(registry)}")
    return registry[key]
