"""Counter-based dropout bits: Philox4x32-10 in plain PyTorch (the contract of ``csrc/philox.cuh``).

The TPU kernels draw their dropout masks from the TPU core PRNG, which neither CUDA nor
torch can reproduce. The port instead makes every mask a pure function of
``(seed, site, element index)``:

* key ``(seed, site)``: one base seed per training step, and a fixed index per dropout
  site of the model (:mod:`..models.wav2vec2` numbers them);
* counter ``(g mod 2^32, g div 2^32, 0, 0)`` with ``g = index >> 2``; element ``index``
  takes word ``index & 3`` of that counter's four output words;
* ``index`` runs over the real tensor in row-major order, never over a block or tile, so
  the CUDA kernels, whatever their tiling, and this plain version give identical bits,
  and a backward regenerates its forward's mask with no storage.

An element is kept when ``bits >= threshold(rate)`` with the JAX package's threshold
``uint32(rate * (2^32 - 1))`` (``ops/pallas/dropout.py:37-39``); kept values are scaled by
``keep_scale(rate)``, the float32 ``1 / (1 - rate)``.

Plain torch has no unsigned 32x32 -> 64-bit multiply, and ``0xD2511F53 * 0xFFFFFFFF``
overflows int64, so :func:`_mulhilo` multiplies the 32-bit constant by 16-bit limbs of the
counter word: every partial product stays below 2^49.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57           # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85           # Weyl key increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10


@functools.cache        # every kernel launch asks; rates are a handful of config values
def threshold(rate: float) -> int:
    """``uint32(min(1, rate) * (2^32 - 1))``, truncated as numpy's float -> uint32 cast."""
    return int(np.uint32(min(1.0, rate) * np.iinfo(np.uint32).max))


@functools.cache
def keep_scale(rate: float) -> float:
    """The float32 ``1 / (1 - rate)`` that kept values are multiplied by (1.0 at rate 0)."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a`` and int64 ``b`` in
    ``[0, 2^32)``, in int64 arithmetic that never overflows."""
    p0 = a * (b & 0xFFFF)                      # < 2^48
    p1 = a * (b >> 16)                         # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)           # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
               k0: int, k1: int) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 counter words; returns four words."""
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits(seed: int, site: int, n: int, device=None) -> torch.Tensor:
    """The uint32 dropout bits (as int64) of elements ``0 .. n-1`` at ``(seed, site)``."""
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32(g & MASK32, g >> 32, zero, zero, seed, site)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_mask(seed: int, site: int, shape, rate: float, device=None) -> torch.Tensor:
    """Boolean keep-mask of ``shape`` (row-major element index); all True at rate 0."""
    shape = tuple(shape)
    if rate <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return (bits(seed, site, int(np.prod(shape)), device) >= threshold(rate)).reshape(shape)
