"""Dropout (K1): the hand-written CUDA kernel, its plain version, and the autograd op.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/dropout.py::prng_dropout``:
``out = keep ? x * scale : 0`` in the input dtype, where ``keep`` is the Philox mask of
``(seed, site)`` over the flat element index (:mod:`..philox`) and ``scale`` the float32
``1 / (1 - rate)``. The backward is the same operation on the cotangent, so it regenerates
the forward's mask. :func:`dropout` takes the plain version only for CPU tensors; a CUDA
tensor goes to the kernel (``csrc/dropout.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import philox
from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I64, _U32, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_int)
VECTOR_BYTES = 16       # K2's bulk copies and accesses: 8 bf16 or 4 f32


def dropout_reference(x: torch.Tensor, seed: int, site: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version: the same mask and float32 scaling, rounded to ``x.dtype``."""
    keep = philox.keep_mask(seed, site, x.shape, rate, x.device)
    return torch.where(keep, x.float() * philox.keep_scale(rate), 0.0).to(x.dtype)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The argument checks every kernel wrapper makes: CUDA, float32/bfloat16, contiguous."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The check of the kernels that move whole rows by bulk copies and 16-byte accesses: each
    tensor's first element on 16 bytes (as :func:`check_cuda` asks for contiguity)."""
    for t in tensors:
        if t.data_ptr() % VECTOR_BYTES:
            raise ValueError(f"{name} needs tensors that start on {VECTOR_BYTES} bytes, got one "
                             f"at {t.data_ptr() % VECTOR_BYTES} bytes past")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes (a copy only where it is not): what an
    autograd op hands the wrappers that :func:`check_aligned`."""
    t = t.contiguous()
    return t if t.data_ptr() % VECTOR_BYTES == 0 else t.clone()


def on_card(t: torch.Tensor) -> bool:
    """The route of an op with a kernel, for its input ``t``: the kernel wrapper for a tensor
    on a CUDA device (which launches or raises), the plain version for a CPU tensor."""
    return t.device.type != "cpu"


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent grids' width."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dropout_kernel(x: torch.Tensor, seed: int, site: int, rate: float) -> torch.Tensor:
    """Launch ``csrc/dropout.cu`` on the current stream; counts launches in ``.launches``."""
    check_cuda("dropout_kernel", x)
    out = torch.empty_like(x)
    if x.numel():
        fn = build.entry("dropout", "dropout_apply", (_P, _P, _I64, _U32, _U32, _U32, _F, _I, _P))
        build.check(fn(x.data_ptr(), out.data_ptr(), x.numel(), seed, site,
                       philox.threshold(rate), philox.keep_scale(rate), DTYPE_CODES[x.dtype],
                       build.stream(x)), "dropout_kernel")
        dropout_kernel.launches += 1
    return out


dropout_kernel.launches = 0


def philox_bits_kernel(n: int, seed: int, site: int, device) -> torch.Tensor:
    """The raw bits of elements ``0 .. n-1`` from ``csrc/philox.cuh`` (int64 of uint32
    values, as :func:`..philox.bits`); used to hold the header to the plain bits."""
    out = torch.empty(n, dtype=torch.int32, device=device)
    fn = build.entry("dropout", "philox_fill", (_P, _I64, _U32, _U32, _P))
    build.check(fn(out.data_ptr(), n, seed, site, build.stream(out)), "philox_fill")
    return out.to(torch.int64) & philox.MASK32


def _apply(x: torch.Tensor, seed: int, site: int, rate: float) -> torch.Tensor:
    if on_card(x):
        return dropout_kernel(x.contiguous(), seed, site, rate)
    return dropout_reference(x, seed, site, rate)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, site, rate):
        ctx.args = (seed, site, rate)
        return _apply(x, seed, site, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None, None


def dropout(x: torch.Tensor, seed: int, site: int, rate: float) -> torch.Tensor:
    """Training dropout of ``x`` at ``(seed, site)``; differentiable. The port takes this
    route whenever it trains, at any rate (rate 0 copies)."""
    return _Dropout.apply(x, seed, site, rate)
