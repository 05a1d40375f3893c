"""Reverse-diffusion samplers as a step loop on the device (port of
``models/diffusion/samplers.py``).

Both samplers start from N(0, 1) of length ``hop * mel_frames`` and return
``(audio [B, T], sample_rate)``. DiffWave's fast path maps its 6 inference betas onto
fractional training steps by matching alpha_cumprod (:func:`align_fast_steps`); WaveGrad
optionally sub-samples its 1000 steps. Per step: the epsilon update, plus sigma-scaled noise
(sigma is 0 at the last step), then a clamp to [-1, 1].

The per-step scalars (mapped step, c1, c2, sigma) are built on the host in float64 and
rounded to float32, as the JAX sampler stacks them for its ``lax.scan``; the loop runs the
model once a step under ``torch.inference_mode``. The initial noise and every step's noise
come from ``generator`` (on its device), or, given ``draws = (initial [B, T], steps
[S, B, T])``, from those tensors: the tests pass the JAX sampler's own draws.
:func:`align_fast_steps` and :func:`_sigmas` are copies of the originals.
"""

from __future__ import annotations

import numpy as np
import torch

from .schedules import NoiseSchedule


def align_fast_steps(train_sched: NoiseSchedule, infer_sched: NoiseSchedule) -> np.ndarray:
    """Map each inference step to a fractional training step by matching alpha_cumprod."""
    train_cum = train_sched.alpha_cumprod
    infer_cum = infer_sched.alpha_cumprod
    steps = []
    for s in range(len(infer_cum)):
        for t in range(len(train_cum) - 1):
            if train_cum[t + 1] <= infer_cum[s] <= train_cum[t]:
                frac = ((train_cum[t] ** 0.5 - infer_cum[s] ** 0.5)
                        / (train_cum[t] ** 0.5 - train_cum[t + 1] ** 0.5))
                steps.append(t + frac)
                break
    return np.asarray(steps, dtype=np.float32)


def _sigmas(alpha_cum: np.ndarray, betas: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Posterior noise scale per visited step; 0 at the final (n == 0) step."""
    out = np.zeros(len(indices))
    for i, n in enumerate(indices):
        if n > 0:
            out[i] = ((1.0 - alpha_cum[n - 1]) / (1.0 - alpha_cum[n]) * betas[n]) ** 0.5
    return out


def _prepare(model, conditioner, label) -> tuple[torch.Tensor, torch.Tensor]:
    device = next(model.parameters()).device
    conditioner = torch.as_tensor(conditioner, dtype=torch.float32).to(device)
    if conditioner.ndim == 2:
        conditioner = conditioner[None]
    label = torch.as_tensor(label).reshape(-1).long().to(device)
    if label.shape[0] == 1 and conditioner.shape[0] > 1:
        label = label.expand(conditioner.shape[0])
    return conditioner, label


@torch.inference_mode()
def _reverse(apply, conditioner, n_samples: int, steps, c1, c2, sigma, generator, draws):
    batch = conditioner.shape[0]
    shape = (batch, n_samples)
    device = conditioner.device

    def normal():
        return torch.randn(shape, generator=generator, device=generator.device).to(device)

    audio = normal() if draws is None else torch.as_tensor(draws[0]).to(device)
    for i, (step, a, b, s) in enumerate(zip(*(np.asarray(v, np.float32).tolist()
                                              for v in (steps, c1, c2, sigma)))):
        eps = apply(audio, torch.full((batch,), step, device=device), conditioner)
        audio = (audio - b * eps) / a
        if s > 0.0:
            noise = normal() if draws is None else torch.as_tensor(draws[1][i]).to(device)
            audio = audio + s * noise
        audio = torch.clamp(audio, -1.0, 1.0)
    return audio


def diffwave_sample(model, conditioner, label, generator: torch.Generator | None, *,
                    fast: bool = True, draws=None):
    """Returns (audio [B, hop*frames], sample_rate)."""
    cfg = model.config
    conditioner, label = _prepare(model, conditioner, label)

    train_sched = cfg.training_schedule()
    infer_sched = (NoiseSchedule(tuple(np.asarray(cfg.inference_betas, dtype=np.float64)))
                   if fast else train_sched)
    mapped = (align_fast_steps(train_sched, infer_sched) if fast
              else np.arange(len(train_sched), dtype=np.float32))

    beta = np.asarray(infer_sched.betas)
    alpha = infer_sched.alphas
    alpha_cum = infer_sched.alpha_cumprod
    order = np.arange(len(alpha))[::-1]                      # N-1 .. 0

    c1 = alpha[order] ** 0.5
    c2 = beta[order] / (1.0 - alpha_cum[order]) ** 0.5
    audio = _reverse(lambda x, step, cond: model(x, step, cond, label), conditioner,
                     cfg.hop_length * conditioner.shape[-1], mapped[order], c1, c2,
                     _sigmas(alpha_cum, beta, order), generator, draws)
    return audio, cfg.sample_rate


def wavegrad_sample(model, conditioner, label, generator: torch.Generator | None, *,
                    num_steps: int | None = None, draws=None):
    """Returns (audio [B, hop*frames], sample_rate)."""
    cfg = model.config
    conditioner, label = _prepare(model, conditioner, label)

    sched = cfg.training_schedule()
    beta = np.asarray(sched.betas)
    alpha = sched.alphas
    alpha_cum = sched.alpha_cumprod
    noise_scale = np.sqrt(alpha_cum)

    order = np.arange(len(alpha))[::-1]
    if num_steps is not None and num_steps < len(alpha):
        order = np.unique(np.linspace(0, len(alpha) - 1, num_steps).round().astype(int))[::-1]

    c1 = alpha[order] ** 0.5
    c2 = (1.0 - alpha[order]) / (1.0 - alpha_cum[order]) ** 0.5
    audio = _reverse(lambda x, level, cond: model(x, cond, level, label), conditioner,
                     cfg.hop_length * conditioner.shape[-1], noise_scale[order], c1, c2,
                     _sigmas(alpha_cum, beta, order), generator, draws)
    return audio, cfg.sample_rate
