"""GELU forms of the training kernels in plain PyTorch (the contract of ``csrc/gelu.cuh``).

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/conv.py:47-104``. The FFN activation kernel
(K5) evaluates GELU by the compute dtype, as the JAX package's does (``ffn.py:38-50``):

* float32: the Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7) and its
  gradient;
* bfloat16: the tanh approximation (|error| vs erf < 1e-3, below one bf16 ulp at unit
  scale) and its own gradient.

Eval paths keep the exact erf of ``torch.nn.functional.gelu``. Inputs are taken in
float32; outputs are float32.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
TANH_K0 = 0.7978845608028654      # sqrt(2 / pi)
TANH_K1 = 0.044715


def erf_rational(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf, with ``sign(0) = 0`` as ``jnp.sign``."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return 0.5 * x * (1.0 + erf_rational(x / SQRT2))


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return 0.5 * (1.0 + erf_rational(x / SQRT2)) + x * torch.exp(-0.5 * x * x) * INV_SQRT_2PI


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    u = TANH_K0 * (x + TANH_K1 * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    u = TANH_K0 * (x + TANH_K1 * x * x * x)
    th = torch.tanh(u)
    du = TANH_K0 * (1.0 + 3.0 * TANH_K1 * x * x)
    return 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * du
