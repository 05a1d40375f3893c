"""Diffusion vocoders (DiffWave, WaveGrad) with step-loop samplers (port of
``models/diffusion``)."""

from .diffwave import DiffWave, DiffWaveConfig, build_diffwave
from .samplers import align_fast_steps, diffwave_sample, wavegrad_sample
from .schedules import DiffusionStepEmbedding, NoiseSchedule, noise_level_encoding
from .wavegrad import WaveGrad, WaveGradConfig, build_wavegrad

__all__ = [
    "DiffWave",
    "DiffWaveConfig",
    "WaveGrad",
    "WaveGradConfig",
    "NoiseSchedule",
    "DiffusionStepEmbedding",
    "noise_level_encoding",
    "diffwave_sample",
    "wavegrad_sample",
    "align_fast_steps",
    "build_diffwave",
    "build_wavegrad",
]
