"""Fused strided conv + erf GELU (K8): the CUDA kernels, their plain versions, autograd.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/conv.py::conv_gelu``, the feature encoder's
``W2VHS_CONVFUSE=1`` route (``Wav2Vec2Config.conv_fuse``): ``gelu(conv1d(x, w, stride 2))``
for kernel 3, VALID, on the port's ``[B, C, T]`` layout with ``w`` nn.Conv1d's
``[Cout, Cin, 3]`` and ``out_len = (T - 3) // 2 + 1`` exactly (no ``conv_time_plan``
padding). As in the JAX kernel (``conv.py:115-126``, :212-302): the products take the input
dtype with float32 sums; the GELU is the erf form in every dtype (the rational erf of
:mod:`..gelu`, the JAX kernel's ``_gelu_exact``; the conv cascade's bfloat16 layers use tanh,
so this route's bfloat16 numbers differ from the default route's on purpose); the
pre-activation is kept in the input dtype and the backward takes the GELU gradient at that
rounded ``pre``, rounds ``dpre`` to the input dtype, and returns ``dx`` (input rows past
``2 out_len`` get only the tap-2 term of the last frame, or nothing) and ``dW``.

:func:`conv_gelu` is the differentiable op. It takes the plain versions only for CPU
tensors; CUDA tensors go to ``csrc/conv_gelu.cu`` (forward; backward: ``dpre``, ``dx``,
``dW`` as float32 partials reduced in a second pass) or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import gelu
from . import build
from .dropout import DTYPE_CODES, check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
CHANNEL_TILE = 128      # Cin and Cout must be multiples of it
MAX_PARTS = 32          # dW partials: at most this many row ranges of B * out_len
ROWS_PER_PART = 4096    # and at least this many rows each


def out_length(t: int) -> int:
    """Output frames of the k = 3, s = 2 VALID conv of ``t`` input frames."""
    return (t - 3) // 2 + 1


def conv_gelu_fwd_reference(x: torch.Tensor, w: torch.Tensor):
    """Plain forward: ``(out, pre)`` in ``x.dtype`` from float32 products of the input
    values (exact for bfloat16 inputs) and the erf GELU of the float32 sums."""
    y = F.conv1d(x.float(), w.float(), stride=2)
    return gelu.gelu_erf(y).to(x.dtype), y.to(x.dtype)


def conv_gelu_bwd_reference(x: torch.Tensor, w: torch.Tensor, pre: torch.Tensor,
                            g: torch.Tensor):
    """Plain backward: ``(dx, dw)`` in the input dtypes from ``dpre`` rounded to
    ``x.dtype``, with float32 sums."""
    dpre = (g.float() * gelu.gelu_erf_grad(pre)).to(x.dtype).float()
    dx = torch.nn.grad.conv1d_input(x.shape, w.float(), dpre, stride=2)
    dw = torch.nn.grad.conv1d_weight(x.float(), w.shape, dpre, stride=2)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int, int, int]:
    check_cuda(name, x, w)
    if x.ndim != 3 or w.ndim != 3 or w.shape[2] != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: expected x [B, Cin, T] and w [Cout, Cin, 3], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, cin, t = x.shape
    cout = w.shape[0]
    if cin % CHANNEL_TILE or cout % CHANNEL_TILE or t < 3:
        raise ValueError(f"{name}: channels must be multiples of {CHANNEL_TILE} and T >= 3, "
                         f"got Cin={cin}, Cout={cout}, T={t}")
    if w.dtype != x.dtype or w.data_ptr() % 16:
        raise ValueError(f"{name}: w must be a 16-byte aligned {x.dtype} tensor")
    return B, cin, t, cout, out_length(t)


def conv_gelu_fwd_kernel(x: torch.Tensor, w: torch.Tensor):
    """Launch the forward of ``csrc/conv_gelu.cu``; counts launches in ``.launches``.
    Returns ``(out, pre)``, each ``[B, Cout, out_len]`` in ``x.dtype``."""
    B, cin, t, cout, out_len = _check("conv_gelu_fwd_kernel", x, w)
    out = torch.empty((B, cout, out_len), dtype=x.dtype, device=x.device)
    pre = torch.empty_like(out)
    fn = build.entry("conv_gelu", "conv_gelu_fwd", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P))
    build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), pre.data_ptr(), B, cin, t, cout,
                   out_len, DTYPE_CODES[x.dtype], build.stream(x)), "conv_gelu_fwd_kernel")
    conv_gelu_fwd_kernel.launches += 1
    return out, pre


def conv_gelu_bwd_kernel(x: torch.Tensor, w: torch.Tensor, pre: torch.Tensor, g: torch.Tensor,
                         need_dx: bool = True, need_dw: bool = True):
    """Launch the backward of ``csrc/conv_gelu.cu`` (``dpre``, then ``dx`` and the ``dW``
    partials and their reduction, each where needed); counts calls in ``.launches``.
    Returns ``(dx, dw)`` (``None`` where not needed)."""
    B, cin, t, cout, out_len = _check("conv_gelu_bwd_kernel", x, w)
    check_cuda("conv_gelu_bwd_kernel", pre, g)
    shape = (B, cout, out_len)
    if tuple(pre.shape) != shape or tuple(g.shape) != shape or {pre.dtype, g.dtype} != {x.dtype}:
        raise ValueError(f"conv_gelu_bwd_kernel: pre and g must be {x.dtype} {list(shape)}")
    wt = w.permute(2, 1, 0).contiguous()                     # [3, Cin, Cout]
    dpre = torch.empty_like(pre)
    dx = torch.empty_like(x) if need_dx else None
    n_parts = max(1, min(MAX_PARTS, B * out_len // ROWS_PER_PART))
    parts = (torch.empty((n_parts, cout, 3 * cin), dtype=torch.float32, device=x.device)
             if need_dw else None)
    dw = torch.empty_like(w) if need_dw else None
    fn = build.entry("conv_gelu", "conv_gelu_bwd",
                     (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    ptr = lambda a: a.data_ptr() if a is not None else None   # noqa: E731
    build.check(fn(x.data_ptr(), wt.data_ptr(), pre.data_ptr(), g.data_ptr(), dpre.data_ptr(),
                   ptr(dx), ptr(parts), ptr(dw), B, cin, t, cout, out_len, n_parts,
                   int(need_dx), int(need_dw), DTYPE_CODES[x.dtype], build.stream(x)),
                "conv_gelu_bwd_kernel")
    conv_gelu_bwd_kernel.launches += 1
    return dx, dw


conv_gelu_fwd_kernel.launches = 0
conv_gelu_bwd_kernel.launches = 0


class _ConvGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        if x.device.type == "cpu":
            out, pre = conv_gelu_fwd_reference(x, w)
        else:
            x, w = x.contiguous(), w.contiguous()
            out, pre = conv_gelu_fwd_kernel(x, w)
        ctx.save_for_backward(x, w, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, pre = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        if g.device.type == "cpu":
            dx, dw = conv_gelu_bwd_reference(x, w, pre, g)
        else:
            dx, dw = conv_gelu_bwd_kernel(x, w, pre, g.contiguous(), need_dx, need_dw)
        return (dx if need_dx else None), (dw if need_dw else None)


def conv_gelu(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``gelu(conv1d(x, w, stride=2))`` for ``x [B, Cin, T]`` and ``w [Cout, Cin, 3]`` ->
    ``[B, Cout, (T - 3) // 2 + 1]``, erf GELU; differentiable."""
    return _ConvGelu.apply(x, w)
