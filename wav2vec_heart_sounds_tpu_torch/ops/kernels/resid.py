"""Residual tail ``LayerNorm(x + dropout(h))`` (K2): CUDA kernels, plain versions, autograd op.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/resid.py::dropout_add_layernorm``. The sum is
rounded to the compute dtype before the float32 statistics and saved for the backward, which
regenerates the Philox mask of ``(seed, site)`` (:mod:`..philox`) instead of storing it.
``weight``/``bias`` are the float32 LayerNorm parameters. :func:`dropout_add_layernorm`
takes the plain versions only for CPU tensors; CUDA tensors go to ``csrc/resid.cu``, which
takes every row width :func:`kernel_takes` names, or raise.

The kernels run a persistent grid (:func:`grid_blocks`: one or two blocks an SM) over tiles
of consecutive rows, tile t on block ``t % blocks``; the backward writes one float32 partial
row of each column sum per block, which the wrapper adds in block order. Rows move by bulk
copies and 16-byte accesses, so every ``[rows, cols]`` tensor starts on 16 bytes
(:func:`.dropout.check_aligned`).

The pre-norm form (:func:`dropout_add_layernorm_prenorm`, the stable-layer-norm encoder's
sublayer tail): the same forward, returning the residual stream ``s`` beside the next
sublayer's input ``LN(s)``; its backward takes both their gradients, and the LayerNorm's
``ds`` plus the stream's own gradient is ``dx``, masked and scaled into ``dh``. Its kernels
count their launches apart (``resid_prenorm_*_kernel.launches``, the counter
``resid.prenorm.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.observe import count
from .. import philox
from . import build
from .dropout import (DTYPE_CODES, VECTOR_BYTES, aligned, check_aligned, check_cuda, on_card,
                      sm_count)

_P, _U32, _F, _I = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int
MAX_COLS = 1024     # widest row of the guarded instance (wav2vec2-large's hidden size)
WIDE_COLS = (1280,)  # wider rows with an instance of their own (XLS-R 1B's hidden size)


def kernel_takes(cols: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take rows of ``cols`` in ``dtype``: float32 or bfloat16 rows of
    whole 16-byte runs (a multiple of 8 columns in bfloat16, of 4 in float32) up to 1024
    columns, or of :data:`WIDE_COLS`. The wrappers raise on anything else."""
    return (dtype in DTYPE_CODES and (0 < cols <= MAX_COLS or cols in WIDE_COLS)
            and cols * dtype.itemsize % VECTOR_BYTES == 0)


def _stats(sf: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    mean = sf.mean(dim=-1, keepdim=True)
    var = ((sf * sf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def dropout_add_reference(h, x, seed: int, site: int, rate: float) -> torch.Tensor:
    """Plain residual sum ``s = round(x + dropout(h))`` in ``h.dtype``."""
    keep = philox.keep_mask(seed, site, h.shape, rate, h.device)
    hf = torch.where(keep, h.float() * philox.keep_scale(rate), 0.0)
    return (x.float() + hf).to(h.dtype)


def layer_norm_reference(s, weight, bias, eps: float) -> torch.Tensor:
    """Plain row LayerNorm of ``s`` with float32 statistics, in ``s.dtype``."""
    sf = s.float()
    mean, rstd = _stats(sf, eps)
    return ((sf - mean) * rstd * weight + bias).to(s.dtype)


def resid_fwd_reference(h, x, weight, bias, seed: int, site: int, rate: float, eps: float):
    """Plain forward: ``(out, s)`` with ``s = round(x + dropout(h))`` in ``h.dtype``."""
    s = dropout_add_reference(h, x, seed, site, rate)
    return layer_norm_reference(s, weight, bias, eps), s


def resid_bwd_reference(g, s, weight, seed: int, site: int, rate: float, eps: float,
                        g_stream=None):
    """Plain backward: ``(dh, dx, dweight, dbias)``; the vector gradients are float32. With
    ``g_stream`` (the pre-norm form) that gradient of ``s`` is added to the LayerNorm's in
    float32."""
    sf, gf = s.float(), g.float()
    mean, rstd = _stats(sf, eps)
    shat = (sf - mean) * rstd
    gs = gf * weight
    ds = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - shat * (gs * shat).mean(dim=-1, keepdim=True))
    if g_stream is not None:
        ds = ds + g_stream.float()
    keep = philox.keep_mask(seed, site, g.shape, rate, g.device)
    dh = torch.where(keep, ds * philox.keep_scale(rate), 0.0).to(g.dtype)
    c = g.shape[-1]
    return dh, ds.to(g.dtype), (gf * shat).reshape(-1, c).sum(0), gf.reshape(-1, c).sum(0)


@functools.cache
def grid_blocks(rows: int, cols: int, dtype: torch.dtype, device: torch.device,
                backward: int) -> int:
    """The kernels' persistent grid on ``device``: as many blocks as fit on its SMs (at most
    two an SM, by the occupancy API in ``csrc/resid.cu``), at most one per tile. ``backward``:
    0 the forward, 1 the backward, 2 the pre-norm backward."""
    fn = build.entry("resid", "resid_blocks", (_I, _I, _I, _I, _I))
    blocks = fn(rows, cols, sm_count(device), DTYPE_CODES[dtype], int(backward))
    if blocks <= 0:
        raise RuntimeError(f"resid_blocks: no grid for rows={rows}, cols={cols}, {dtype}")
    return blocks


def _check(name, rows_like: torch.Tensor, *vectors: torch.Tensor) -> tuple[int, int]:
    c = rows_like.shape[-1]
    if not kernel_takes(c, rows_like.dtype):
        raise ValueError(f"{name}: row width {c} in {rows_like.dtype}; the kernel takes rows "
                         f"of 16-byte runs up to {MAX_COLS} columns")
    for v in vectors:
        if v.dtype != torch.float32 or not v.is_cuda or tuple(v.shape) != (c,):
            raise ValueError(f"{name}: LayerNorm parameters must be float32 CUDA [{c}]")
    return rows_like.numel() // c, c


def _fwd(name, h, x, weight, bias, seed: int, site: int, rate: float, eps: float):
    check_cuda(name, h, x)
    check_aligned(name, h, x)
    if x.dtype != h.dtype or x.shape != h.shape:
        raise ValueError(f"{name}: h and x must share shape and dtype")
    rows, cols = _check(name, h, weight, bias)
    out, s = torch.empty_like(h), torch.empty_like(h)
    fn = build.entry("resid", "resid_fwd",
                     (_P, _P, _P, _P, _P, _P, _I, _I, _F, _U32, _U32, _U32, _F, _I, _I, _P))
    blocks = grid_blocks(rows, cols, h.dtype, h.device, False)
    build.check(fn(h.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), s.data_ptr(), rows, cols, eps, seed, site,
                   philox.threshold(rate), philox.keep_scale(rate), blocks,
                   DTYPE_CODES[h.dtype], build.stream(h)), name)
    return out, s


def resid_fwd_kernel(h, x, weight, bias, seed: int, site: int, rate: float, eps: float):
    """Launch the forward of ``csrc/resid.cu``; counts launches in ``.launches``."""
    out, s = _fwd("resid_fwd_kernel", h, x, weight, bias, seed, site, rate, eps)
    resid_fwd_kernel.launches += 1
    return out, s


def resid_prenorm_fwd_kernel(h, x, weight, bias, seed: int, site: int, rate: float,
                             eps: float):
    """The pre-norm form's forward: the forward of ``csrc/resid.cu``, ``(out, s)``; counts
    launches in ``.launches`` and ``resid.prenorm.launches``."""
    out, s = _fwd("resid_prenorm_fwd_kernel", h, x, weight, bias, seed, site, rate, eps)
    resid_prenorm_fwd_kernel.launches += 1
    count("resid.prenorm.launches")
    return out, s


def resid_bwd_kernel(g, s, weight, seed: int, site: int, rate: float, eps: float):
    """Launch the backward of ``csrc/resid.cu``; counts launches in ``.launches``."""
    check_cuda("resid_bwd_kernel", g, s)
    check_aligned("resid_bwd_kernel", g, s)
    if s.dtype != g.dtype or s.shape != g.shape:
        raise ValueError("resid_bwd_kernel: g and s must share shape and dtype")
    rows, cols = _check("resid_bwd_kernel", g, weight)
    blocks = grid_blocks(rows, cols, g.dtype, g.device, 1)
    dh, dx = torch.empty_like(g), torch.empty_like(g)
    parts = torch.empty((2, blocks, cols), dtype=torch.float32, device=g.device)
    fn = build.entry("resid", "resid_bwd",
                     (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _U32, _U32, _U32, _F, _I, _I, _P))
    build.check(fn(g.data_ptr(), s.data_ptr(), weight.data_ptr(), dh.data_ptr(), dx.data_ptr(),
                   parts[0].data_ptr(), parts[1].data_ptr(), rows, cols, eps, seed, site,
                   philox.threshold(rate), philox.keep_scale(rate), blocks,
                   DTYPE_CODES[g.dtype], build.stream(g)), "resid_bwd_kernel")
    resid_bwd_kernel.launches += 1
    dweight, dbias = parts.sum(dim=1)
    return dh, dx, dweight, dbias


def resid_prenorm_bwd_kernel(g, g_stream, s, weight, seed: int, site: int, rate: float,
                             eps: float):
    """Launch the pre-norm backward of ``csrc/resid.cu`` (``g`` the gradient of ``out``,
    ``g_stream`` that of ``s``); counts launches in ``.launches`` and
    ``resid.prenorm.launches``. Returns what :func:`resid_bwd_reference` returns with
    ``g_stream``."""
    name = "resid_prenorm_bwd_kernel"
    check_cuda(name, g, g_stream, s)
    check_aligned(name, g, g_stream, s)
    if s.dtype != g.dtype or s.shape != g.shape or g_stream.dtype != g.dtype or \
            g_stream.shape != g.shape:
        raise ValueError(f"{name}: g, g_stream and s must share shape and dtype")
    rows, cols = _check(name, g, weight)
    blocks = grid_blocks(rows, cols, g.dtype, g.device, 2)
    dh, dx = torch.empty_like(g), torch.empty_like(g)
    parts = torch.empty((2, blocks, cols), dtype=torch.float32, device=g.device)
    fn = build.entry("resid", "resid_prenorm_bwd",
                     (_P,) * 8 + (_I, _I, _F, _U32, _U32, _U32, _F, _I, _I, _P))
    build.check(fn(g.data_ptr(), g_stream.data_ptr(), s.data_ptr(), weight.data_ptr(),
                   dh.data_ptr(), dx.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), rows,
                   cols, eps, seed, site, philox.threshold(rate), philox.keep_scale(rate), blocks,
                   DTYPE_CODES[g.dtype], build.stream(g)), name)
    resid_prenorm_bwd_kernel.launches += 1
    count("resid.prenorm.launches")
    dweight, dbias = parts.sum(dim=1)
    return dh, dx, dweight, dbias


resid_fwd_kernel.launches = 0
resid_bwd_kernel.launches = 0
resid_prenorm_fwd_kernel.launches = 0
resid_prenorm_bwd_kernel.launches = 0


class _ResidTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, weight, bias, seed, site, rate, eps):
        args = (seed, site, rate, eps)
        if on_card(h):
            out, s = resid_fwd_kernel(aligned(h), aligned(x), weight, bias, *args)
        else:
            out, s = resid_fwd_reference(h, x, weight, bias, *args)
        ctx.save_for_backward(s, weight)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, g):
        s, weight = ctx.saved_tensors
        if on_card(g):
            dh, dx, dw, db = resid_bwd_kernel(aligned(g), s, weight, *ctx.args)
        else:
            dh, dx, dw, db = resid_bwd_reference(g, s, weight, *ctx.args)
        need = ctx.needs_input_grad            # frozen LayerNorm parameters (LoRA)
        return (dh, dx if need[1] else None, dw if need[2] else None, db if need[3] else None,
                None, None, None, None)


def dropout_add_layernorm(h, x, weight, bias, seed: int, site: int, rate: float,
                          eps: float = 1e-5) -> torch.Tensor:
    """``LayerNorm(x + dropout(h))`` over the last axis, in ``h.dtype``; differentiable."""
    return _ResidTail.apply(h, x.to(h.dtype), weight, bias, seed, site, rate, eps)



class _PrenormTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, weight, bias, seed, site, rate, eps):
        args = (seed, site, rate, eps)
        if on_card(h):
            out, s = resid_prenorm_fwd_kernel(aligned(h), aligned(x), weight, bias, *args)
        else:
            out, s = resid_fwd_reference(h, x, weight, bias, *args)
        ctx.save_for_backward(s, weight)
        ctx.args = args
        return s, out

    @staticmethod
    def backward(ctx, g_stream, g):
        s, weight = ctx.saved_tensors
        g = torch.zeros_like(s) if g is None else g
        g_stream = torch.zeros_like(s) if g_stream is None else g_stream
        if on_card(g):
            dh, dx, dw, db = resid_prenorm_bwd_kernel(aligned(g), aligned(g_stream), s, weight,
                                                      *ctx.args)
        else:
            dh, dx, dw, db = resid_bwd_reference(g, s, weight, *ctx.args, g_stream=g_stream)
        need = ctx.needs_input_grad
        return (dh, dx if need[1] else None, dw if need[2] else None, db if need[3] else None,
                None, None, None, None)


def dropout_add_layernorm_prenorm(h, x, weight, bias, seed: int, site: int, rate: float,
                                  eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-norm tail: ``(s, LayerNorm(s))`` with the stream ``s = x + dropout(h)`` in
    ``h.dtype``; differentiable in both outputs."""
    return _PrenormTail.apply(h, x.to(h.dtype), weight, bias, seed, site, rate, eps)
