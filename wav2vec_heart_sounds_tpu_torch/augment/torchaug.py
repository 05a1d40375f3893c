"""Batched waveform augmentation on the card (port of ``augment/jaxaug.py``).

Mono PCG (:func:`augment_pcg_batch`): the on-device twin of the host PCG pipeline's
tensor-friendly subset: additive white noise, the sinusoidal volume envelope and a random
parametric EQ (five first-order Butterworth band sections, edges shared across the batch),
each applied through a per-row Bernoulli gate and followed by abs-max renormalisation, in
the JAX package's stage order (noise, envelope, EQ, noise).

Vest (:func:`augment_multi_pcg_batch`, ``[B, T, C]``): the tail of the multichannel host
pipeline after its host residue (``data/vest.py::multi_augment_host_residual``): the
wander envelope, white noise and recorded noise from an on-device bank, in that order,
each gated once per sample and shared across its microphones so inter-channel phase is
kept; wander and recorded noise renormalise, white noise does not.

Rows that do not participate at all (``row_mask`` / ``pristine_prob``) pass through
bit-identically. :func:`baseline_wander` and :func:`amplitude_warp` are ports of the JAX
module's standalone transforms (no pipeline stage calls them), taking their draws as the
others do.

Randomness is split from the arithmetic so both can be tested: :func:`draw_pcg_batch`
takes every draw from a CPU ``torch.Generator`` in a fixed order (small per-row
uniforms on the host; each ``[B, T]`` white-noise field on the card from a
``torch.Generator`` seeded from it), and :func:`apply_pcg_batch` is the deterministic
core. Uniforms are unit draws scaled here exactly as ``jax.random.uniform`` scales them.
Time-stretch and HPSS have no tensor form and stay on the host (:mod:`.pipelines`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import full_fp32
from ..ops.iir import biquad_dynamic, butter1_bandpass_coeffs
from ..ops.normalize import abs_max_normalise as _normalise
from .pipelines import (MULTI_PROB_NOISE, MULTI_PROB_REAL_NOISE, MULTI_PROB_WANDER,
                        AugmentConfig)

NOISE_STDS = (0.0001, 0.001, 0.01)
SINE_BANDS = ((0.05, 0.5), (0.001, 0.05))       # fast and slow envelope sinusoids, Hz
EQ_BANDS = 5
EQ_RANGE = (2.0, 500.0)                          # the PCG parametric EQ's band limits, Hz


def _uniform(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32)


def _noise_draws(generator: torch.Generator, b: int, t: int, device,
                 gates: int | None = None) -> dict:
    """White-noise draws for ``b`` rows of ``t`` samples, with ``gates`` gate uniforms
    (default one per row)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    field = torch.Generator(device=device).manual_seed(seed)
    return {"gate": _uniform(generator, b if gates is None else gates),
            "std": int(torch.randint(0, len(NOISE_STDS), (1,), generator=generator)),
            "scale": _uniform(generator, b),
            "normal": torch.randn((b, t), generator=field, device=device)}


def draw_pcg_batch(generator: torch.Generator, b: int, t: int, device,
                   cfg: AugmentConfig | None = None, *, row_mask: torch.Tensor | None = None,
                   pristine_prob: float | None = None) -> dict:
    """Every random draw of one :func:`augment_pcg_batch` call, in a fixed order: the
    stages that run (probability > 0, as the JAX package drops zero-probability stages),
    then participation."""
    cfg = cfg or AugmentConfig()
    draws: dict = {}
    if cfg.prob_noise > 0:
        draws["noise1"] = _noise_draws(generator, b, t, device)
    if cfg.prob_wandering_volume > 0:
        draws["envelope"] = {"gate": _uniform(generator, b), "amp": _uniform(generator, 2, b),
                             "freq": _uniform(generator, 2, b),
                             "phase": _uniform(generator, 2, b)}
    if cfg.prob_banding > 0:
        draws["eq"] = {"gate": _uniform(generator, b), "low": _uniform(generator, EQ_BANDS),
                       "high": _uniform(generator, EQ_BANDS)}
    if cfg.prob_noise > 0:
        draws["noise2"] = _noise_draws(generator, b, t, device)
    draws.update(_participation(generator, b, row_mask, pristine_prob))
    return draws


def _participation(generator, b: int, row_mask, pristine_prob) -> dict:
    if pristine_prob is not None:
        return {"participate": _uniform(generator, b) >= pristine_prob}
    if row_mask is not None:
        return {"participate": torch.as_tensor(row_mask).cpu() > 0.5}
    return {}


def _blend(x: torch.Tensor, transformed: torch.Tensor, gate: torch.Tensor,
           prob: float) -> torch.Tensor:
    """Rows whose gate uniform is below ``prob`` take the transform; then renormalise."""
    mask = (gate < prob).to(x.dtype).to(x.device)[:, None]
    return _normalise(mask * transformed + (1.0 - mask) * x)


def add_white_noise(x: torch.Tensor, d: dict) -> torch.Tensor:
    scale = (d["scale"].to(x.device, x.dtype) * 0.1)[:, None]
    return x + scale * NOISE_STDS[d["std"]] * d["normal"].to(x.dtype)


def two_band_sines(t: torch.Tensor, d: dict, amp_lo: float, amp_span: float) -> torch.Tensor:
    """Per-row fast and slow random sinusoids ``[B, T]`` at times ``t`` (seconds)."""
    out = torch.zeros((d["amp"].shape[1], t.shape[0]), dtype=t.dtype, device=t.device)
    for i, (lo, hi) in enumerate(SINE_BANDS):
        amp = (amp_lo + d["amp"][i] * amp_span).to(t.device)[:, None]
        freq = (lo + d["freq"][i] * (hi - lo)).to(t.device)[:, None]
        phase = d["phase"][i].to(t.device)[:, None]
        out = out + amp * torch.sin(2 * math.pi * (freq * t + phase))
    return out


def sinusoidal_envelope(x: torch.Tensor, fs: int, d: dict) -> torch.Tensor:
    t = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device) / fs
    return x * (1.0 + two_band_sines(t, d, 0.01, 0.24))


def baseline_wander(x: torch.Tensor, fs: int, d: dict) -> torch.Tensor:
    """Add per-row fast and slow random sinusoids; ``d`` holds unit uniforms ``amp``,
    ``freq`` and ``phase``, each ``[2, B]`` (one row per band), as the envelope's."""
    t = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device) / fs
    return x + two_band_sines(t, d, 0.01, 0.19)


def amplitude_warp(x: torch.Tensor, d: dict, num_points: int = 12,
                   kernel: int = 65) -> torch.Tensor:
    """Per-sample smooth unit-sum gain curve applied as a depthwise 1-D convolution of the
    reflect-padded ``[B, T]`` rows; ``d["amps"]`` holds ``[B, num_points]`` unit uniforms,
    the curve's control points."""
    b, t = x.shape
    amps = 0.7 + d["amps"].to(x.device, x.dtype) * 0.6
    grid = torch.arange(kernel, dtype=x.dtype, device=x.device) / (kernel - 1) * (num_points - 1)
    lo = torch.floor(grid).long().clamp(0, num_points - 1)
    hi = torch.ceil(grid).long().clamp(0, num_points - 1)
    frac = grid - lo
    curve = amps[:, lo] + (amps[:, hi] - amps[:, lo]) * frac[None, :]       # [B, K]
    curve = curve / curve.sum(dim=-1, keepdim=True)
    padded = F.pad(x[None], (kernel // 2, kernel // 2), mode="reflect")    # [1, B, T + K - 1]
    with full_fp32():
        out = F.conv1d(padded, curve[:, None, :], groups=b)
    return out[0, :, :t]


def eq_edges(d: dict, fs: float, low: float = EQ_RANGE[0],
             high: float = EQ_RANGE[1]) -> list[tuple[float, float]]:
    """The bands' (low, high) edges in Hz, kept inside (0, Nyquist) at any rate."""
    nyq = fs / 2.0
    high = min(high, 0.99 * nyq)
    low = min(low, 0.5 * high)
    edges = []
    for u_lo, u_hi in zip(d["low"].tolist(), d["high"].tolist()):
        b_low = low + u_lo * (0.95 * high - low)
        start = b_low + 0.05 * (high - low)
        edges.append((b_low, start + u_hi * (high - start)))
    return edges


def parametric_eq(x: torch.Tensor, fs: float, d: dict) -> torch.Tensor:
    """Blend with a stack of random narrow band sections (edges shared across the batch)."""
    nyq = fs / 2.0
    coloured = x
    for b_low, b_high in eq_edges(d, fs):
        b, a = butter1_bandpass_coeffs(b_low / nyq, b_high / nyq)
        coloured = biquad_dynamic(coloured, b, a)
    return _normalise(_normalise(coloured) / 50.0 + _normalise(x))


def apply_pcg_batch(x: torch.Tensor, fs: int, cfg: AugmentConfig, draws: dict) -> torch.Tensor:
    """The deterministic core of :func:`augment_pcg_batch` for given ``draws``."""
    y = _normalise(x)
    if "noise1" in draws:
        y = _blend(y, add_white_noise(y, draws["noise1"]), draws["noise1"]["gate"],
                   cfg.prob_noise / 4)
    if "envelope" in draws:
        y = _blend(y, sinusoidal_envelope(y, fs, draws["envelope"]), draws["envelope"]["gate"],
                   cfg.prob_wandering_volume)
    if "eq" in draws:
        y = _blend(y, parametric_eq(y, fs, draws["eq"]), draws["eq"]["gate"], cfg.prob_banding)
    if "noise2" in draws:
        y = _blend(y, add_white_noise(y, draws["noise2"]), draws["noise2"]["gate"],
                   cfg.prob_noise / 4)
    part = draws.get("participate")
    if part is None:
        return y
    return torch.where(part.to(x.device)[:, None], y, x)


def augment_pcg_batch(generator: torch.Generator, x: torch.Tensor, fs: int,
                      cfg: AugmentConfig | None = None, *,
                      row_mask: torch.Tensor | None = None,
                      pristine_prob: float | None = None) -> torch.Tensor:
    """Augment a float batch ``[B, T]`` on its device, with every draw from the CPU
    ``generator``. ``pristine_prob`` (a fresh Bernoulli draw keeps about that fraction of
    rows pristine) overrides ``row_mask`` (the loader's replica flag; rows at 0 stay
    pristine); with neither, every row participates."""
    cfg = cfg or AugmentConfig()
    draws = draw_pcg_batch(generator, x.shape[0], x.shape[1], x.device, cfg,
                           row_mask=row_mask, pristine_prob=pristine_prob)
    return apply_pcg_batch(x, fs, cfg, draws)


def draw_multi_pcg_batch(generator: torch.Generator, b: int, c: int, t: int, device, *,
                         bank_size: int = 0, row_mask: torch.Tensor | None = None,
                         pristine_prob: float | None = None) -> dict:
    """Every random draw of one :func:`augment_multi_pcg_batch` call, in a fixed order:
    wander (the envelope of each sample, then its gate), white noise (the gate of each
    sample, then the noise of each of its ``c`` rows), recorded noise (with a bank of
    ``bank_size`` snippets: a snippet and a gate per sample), then participation."""
    draws: dict = {}
    if MULTI_PROB_WANDER > 0:
        draws["wander"] = {"amp": _uniform(generator, 2, b), "freq": _uniform(generator, 2, b),
                           "phase": _uniform(generator, 2, b), "gate": _uniform(generator, b)}
    if MULTI_PROB_NOISE > 0:
        draws["noise"] = _noise_draws(generator, b * c, t, device, gates=b)
    if bank_size and MULTI_PROB_REAL_NOISE > 0:
        draws["recorded"] = {
            "index": torch.randint(0, bank_size, (b,), generator=generator),
            "gate": _uniform(generator, b)}
    draws.update(_participation(generator, b, row_mask, pristine_prob))
    return draws


def _shared(gate: torch.Tensor, prob: float, c: int, device) -> torch.Tensor:
    """``[B*C, 1]`` gate: one draw per sample, shared by its ``c`` microphone rows."""
    return (gate < prob).to(device)[:, None].expand(-1, c).reshape(-1, 1)


def apply_multi_pcg_batch(x: torch.Tensor, fs: int, draws: dict,
                          noise_bank: torch.Tensor | None = None) -> torch.Tensor:
    """The deterministic core of :func:`augment_multi_pcg_batch` for given ``draws``."""
    b, t, c = x.shape
    y = _normalise(x.transpose(1, 2).reshape(b * c, t))
    if "wander" in draws:
        d = draws["wander"]
        tt = torch.arange(t, dtype=y.dtype, device=y.device) / fs
        mod = 1.0 + two_band_sines(tt, d, 0.01, 0.24)                  # one per sample
        wandered = _normalise((y.view(b, c, t) * mod[:, None, :]).reshape(b * c, t))
        y = torch.where(_shared(d["gate"], MULTI_PROB_WANDER, c, y.device), wandered, y)
    if "noise" in draws:
        d = draws["noise"]
        y = torch.where(_shared(d["gate"], MULTI_PROB_NOISE / 4, c, y.device),
                        add_white_noise(y, d), y)
    if "recorded" in draws and noise_bank is not None:
        d = draws["recorded"]
        snip = noise_bank[d["index"].to(noise_bank.device)].to(y.dtype)  # [B, T], all mics
        mixed = _normalise((y.view(b, c, t) + snip[:, None, :]).reshape(b * c, t))
        y = torch.where(_shared(d["gate"], MULTI_PROB_REAL_NOISE, c, y.device), mixed, y)
    y = y.view(b, c, t).transpose(1, 2)
    part = draws.get("participate")
    if part is None:
        return y
    return torch.where(part.to(x.device)[:, None, None], y, x)


def augment_multi_pcg_batch(generator: torch.Generator, x: torch.Tensor, fs: int, *,
                            row_mask: torch.Tensor | None = None,
                            pristine_prob: float | None = None,
                            noise_bank: torch.Tensor | None = None) -> torch.Tensor:
    """Augment a float vest batch ``[B, T, C]`` on its device, every draw from the CPU
    ``generator``; ``noise_bank`` ``[K, T]`` (on the device) enables recorded noise. The
    stage probabilities are the host pipeline's ``MULTI_PROB_*``, as in the JAX package."""
    b, t, c = x.shape
    draws = draw_multi_pcg_batch(generator, b, c, t, x.device,
                                 bank_size=0 if noise_bank is None else noise_bank.shape[0],
                                 row_mask=row_mask, pristine_prob=pristine_prob)
    return apply_multi_pcg_batch(x, fs, draws, noise_bank)
