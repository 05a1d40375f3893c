"""FFN activation ``dropout(gelu(x W^T + b))`` (K5): CUDA kernels, plain versions, autograd op.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/ffn.py::dense_gelu_dropout``. As in the JAX
package, the kernel pair holds only the activation pass; the products (``pre``, ``dx``,
``dW``) are plain matrix products around it. GELU follows the dtype (:mod:`..gelu`):
the rational erf in float32, tanh in bfloat16. The backward regenerates the Philox mask of
``(seed, site)`` and reduces the bias gradient from per-chunk partials. The forward runs a
persistent grid (:func:`grid_blocks`) and moves 16 bytes at a time, so its tensors start on
16 bytes (:func:`.dropout.check_aligned`); the backward takes rows of four-column groups
(:func:`kernel_takes`). :func:`dense_gelu_dropout` takes the plain versions only for CPU
tensors; CUDA tensors go to ``csrc/ffn_act.cu`` or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import gelu, philox
from . import build
from .dropout import DTYPE_CODES, aligned, check_aligned, check_cuda, on_card, sm_count

_P, _I64, _U32, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float,
                          ctypes.c_int)
MAX_CHUNKS = 256


def kernel_takes(cols: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take rows of ``cols`` in ``dtype``: float32 or bfloat16 rows of
    four-column groups (the backward's; the forward takes any length). The wrappers raise on
    anything else."""
    return dtype in DTYPE_CODES and cols > 0 and cols % 4 == 0


def _act(dtype: torch.dtype):
    """(GELU, its gradient) of the kernel for ``dtype``: tanh in bfloat16, erf otherwise."""
    if dtype == torch.bfloat16:
        return gelu.gelu_tanh, gelu.gelu_tanh_grad
    return gelu.gelu_erf, gelu.gelu_erf_grad


def ffn_act_fwd_reference(pre, seed: int, site: int, rate: float) -> torch.Tensor:
    """Plain forward: ``keep ? act(pre) * scale : 0`` in ``pre.dtype``."""
    keep = philox.keep_mask(seed, site, pre.shape, rate, pre.device)
    h = _act(pre.dtype)[0](pre)
    return torch.where(keep, h * philox.keep_scale(rate), 0.0).to(pre.dtype)


def ffn_act_bwd_reference(g, pre, seed: int, site: int, rate: float):
    """Plain backward: ``(dpre in pre.dtype, float32 bias gradient)``."""
    keep = philox.keep_mask(seed, site, g.shape, rate, g.device)
    gd = torch.where(keep, g.float() * philox.keep_scale(rate), 0.0)
    dpre = gd * _act(pre.dtype)[1](pre)
    return dpre.to(pre.dtype), dpre.reshape(-1, pre.shape[-1]).sum(0)


@functools.cache
def grid_blocks(n: int, dtype: torch.dtype, device: torch.device) -> int:
    """The forward's persistent grid over ``n`` elements on ``device``: the blocks an SM fits
    (the occupancy API in ``csrc/ffn_act.cu``) times its SMs, at most one per 256 runs."""
    fn = build.entry("ffn_act", "ffn_act_blocks", (_I64, _I, _I))
    blocks = fn(n, sm_count(device), DTYPE_CODES[dtype])
    if blocks <= 0:
        raise RuntimeError(f"ffn_act_blocks: no grid for n={n}, {dtype}")
    return blocks


def ffn_act_fwd_kernel(pre, seed: int, site: int, rate: float) -> torch.Tensor:
    """Launch the forward of ``csrc/ffn_act.cu``; counts launches in ``.launches``."""
    check_cuda("ffn_act_fwd_kernel", pre)
    check_aligned("ffn_act_fwd_kernel", pre)
    y = torch.empty_like(pre)
    n = pre.numel()
    fn = build.entry("ffn_act", "ffn_act_fwd", (_P, _P, _I64, _U32, _U32, _U32, _F, _I, _I, _P))
    build.check(fn(pre.data_ptr(), y.data_ptr(), n, seed, site, philox.threshold(rate),
                   philox.keep_scale(rate), grid_blocks(n, pre.dtype, pre.device),
                   DTYPE_CODES[pre.dtype], build.stream(pre)), "ffn_act_fwd_kernel")
    ffn_act_fwd_kernel.launches += 1
    return y


def ffn_act_bwd_kernel(g, pre, seed: int, site: int, rate: float):
    """Launch the backward of ``csrc/ffn_act.cu``; counts launches in ``.launches``."""
    if g.dtype != pre.dtype or g.shape != pre.shape:
        raise ValueError("ffn_act_bwd_kernel: g and pre must share shape and dtype")
    cols = pre.shape[-1]
    if not kernel_takes(cols, pre.dtype):
        raise ValueError(f"ffn_act_bwd_kernel: rows of {cols} columns in {pre.dtype}; the "
                         f"kernel takes float32 or bfloat16 rows of four-column groups")
    check_cuda("ffn_act_bwd_kernel", g, pre)
    rows = pre.numel() // cols
    chunks = min(rows, MAX_CHUNKS)
    dpre = torch.empty_like(pre)
    parts = torch.empty((chunks, cols), dtype=torch.float32, device=pre.device)
    fn = build.entry("ffn_act", "ffn_act_bwd",
                     (_P, _P, _P, _P, _I, _I, _U32, _U32, _U32, _F, _I, _I, _P))
    build.check(fn(g.data_ptr(), pre.data_ptr(), dpre.data_ptr(), parts.data_ptr(), rows, cols,
                   seed, site, philox.threshold(rate), philox.keep_scale(rate), chunks,
                   DTYPE_CODES[pre.dtype], build.stream(pre)), "ffn_act_bwd_kernel")
    ffn_act_bwd_kernel.launches += 1
    return dpre, parts.sum(0)


ffn_act_fwd_kernel.launches = 0
ffn_act_bwd_kernel.launches = 0


class _DenseGeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, seed, site, rate):
        pre = F.linear(x, weight, bias)
        args = (seed, site, rate)
        if on_card(pre):
            pre = aligned(pre)
            y = ffn_act_fwd_kernel(pre, *args)
        else:
            y = ffn_act_fwd_reference(pre, *args)
        ctx.save_for_backward(x, weight, pre)
        ctx.args = args
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, pre = ctx.saved_tensors
        if on_card(g):
            dpre, dbias = ffn_act_bwd_kernel(g.contiguous(), pre, *ctx.args)
        else:
            dpre, dbias = ffn_act_bwd_reference(g, pre, *ctx.args)
        dpre2 = dpre.reshape(-1, dpre.shape[-1])
        need = ctx.needs_input_grad            # frozen weights (LoRA) take no products
        dx = (dpre2 @ weight).reshape(x.shape) if need[0] else None
        dweight = dpre2.t() @ x.reshape(-1, x.shape[-1]) if need[1] else None
        return dx, dweight, dbias.to(weight.dtype) if need[2] else None, None, None, None


def dense_gelu_dropout(x, weight, bias, seed: int, site: int, rate: float) -> torch.Tensor:
    """``dropout(gelu(F.linear(x, weight, bias)))`` with the activation kernel; ``weight``
    is ``[out, in]`` (``nn.Linear``); differentiable."""
    return _DenseGeluDropout.apply(x, weight, bias, seed, site, rate)

