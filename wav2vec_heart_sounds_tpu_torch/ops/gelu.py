"""GELU forms of the training kernels in plain PyTorch (the contract of ``csrc/gelu.cuh``).

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/conv.py:47-104``. The FFN activation kernel
(K5) evaluates GELU by the compute dtype, as the JAX package's does (``ffn.py:38-50``):

* float32: the Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7) and its
  gradient;
* bfloat16: the tanh approximation (|error| vs erf < 1e-3, below one bf16 ulp at unit
  scale) and its own gradient.

Eval paths keep the exact erf of ``torch.nn.functional.gelu``. Inputs are taken in
float32; outputs are float32.

On the CPU the exponential and tanh are taken through :func:`_exp` and :func:`_tanh`, not
``torch.exp`` / ``torch.tanh``: those go to MKL's vector math, whose first call in a process
can return one OpenMP thread's chunk at ~13-bit accuracy when several threads enter it at
once (the other chunks and every later call at full accuracy), so a plain result would
depend on the intra-op chunking. CUDA tensors keep ``torch.exp`` / ``torch.tanh``, which
``csrc/gelu.cuh``'s bit-exact forms follow.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
TANH_K0 = 0.7978845608028654      # sqrt(2 / pi)
TANH_K1 = 0.044715
LOG2E = 1.4426950408889634


def _exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` in ``x.dtype``; on the CPU as ``exp2(x log2 e)`` in float64 (SLEEF's vector
    exp2, no MKL), rounded once: exp correctly rounded but for float64 ties."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double() * LOG2E).to(x.dtype)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``tanh(x)`` in ``x.dtype``; on the CPU as ``sign(x) (1 - e) / (1 + e)`` with
    ``e = exp(-2 |x|)`` from :func:`_exp`'s float64 route, rounded once."""
    if x.device.type != "cpu":
        return torch.tanh(x)
    xd = x.double()
    e = torch.exp2(-2.0 * LOG2E * xd.abs())
    return (torch.sign(xd) * (1.0 - e) / (1.0 + e)).to(x.dtype)


def erf_rational(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf, with ``sign(0) = 0`` as ``jnp.sign``."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * _exp(-a * a))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return 0.5 * x * (1.0 + erf_rational(x / SQRT2))


def gelu_erf_grad(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return 0.5 * (1.0 + erf_rational(x / SQRT2)) + x * _exp(-0.5 * x * x) * INV_SQRT_2PI


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    u = TANH_K0 * (x + TANH_K1 * x * x * x)
    return 0.5 * x * (1.0 + _tanh(u))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    u = TANH_K0 * (x + TANH_K1 * x * x * x)
    th = _tanh(u)
    du = TANH_K0 * (1.0 + 3.0 * TANH_K1 * x * x)
    return 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * du
