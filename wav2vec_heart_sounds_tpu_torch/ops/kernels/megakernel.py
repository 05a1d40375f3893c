"""FFN sublayer ``LN(x + drop(W2 drop(gelu(W1 x + b1)) + b2))`` (K4): CUDA kernels, plain
versions, autograd op.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/megakernel.py::ffn_block``, the JAX package's
default training FFN. The plain versions are the decomposed route's composition
(``F.linear`` -> :func:`.ffn.ffn_act_fwd_reference` -> ``F.linear`` ->
:func:`.resid.resid_fwd_reference`, and its backward in the same ops), so on the CPU this
op is bit for bit the K5 + K2 route. The masks are the Philox masks of ``(seed, s_act)``
over ``[N, F]`` and ``(seed, s_hid)`` over ``[N, D]``, the same as that route's.

The kernel pair (``csrc/ffn_mega.cu``) computes the forward's two products and the
backward's ``dhid W2`` itself; ``dx = dpre W1 + ds``, ``dW1 = dpre^T x`` and
``dW2 = dhid^T h`` stay matrix products here, as the JAX package leaves them to XLA.
In both dtypes the kernels run as stages, each with its plain version here: (A)
:func:`ffn_up_reference`, (B) :func:`ffn_down_reference`, the row LayerNorm
(:func:`.resid.layer_norm_reference`), (C) :func:`.resid.resid_bwd_reference` and (D)
:func:`ffn_dgrad_reference`; composed, they are the two plain versions above bit for bit.
The bfloat16 bodies read their operands with TMA and store 16 bytes at a time, so the
wrappers take dense rows whose base and row stride are multiples of 16 bytes, and widths
that :func:`kernel_takes` names, and raise ``ValueError`` otherwise before any CUDA call.
:func:`ffn_block` takes the plain versions only for CPU tensors; CUDA tensors go to the
kernels or raise.

The pre-norm form (:func:`ffn_block_prenorm`, the stable-layer-norm encoder's FFN with the
next LayerNorm fused): the FFN reads ``x`` (the normalised stream) and adds its dropped output
to a separate residual ``r``: ``s = r + drop(W2 drop(gelu(W1 x + b1)) + b2)`` is the new
stream and ``LN(s)`` the next sublayer's input. The same stages with (B) adding to ``r``; its
backward takes the stream's own gradient beside the LayerNorm output's (K2's pre-norm
backward row pass, :func:`.resid.resid_bwd_reference` with ``g_stream``), ``dr = ds`` and
``dx = dpre W1``. Its kernels count their launches apart (``ffn_prenorm_*_kernel.launches``,
the counter ``ffn.prenorm.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ...utils.observe import count
from .. import philox
from . import build
from .dropout import DTYPE_CODES, check_cuda, on_card, sm_count
from .ffn import ffn_act_bwd_reference, ffn_act_fwd_reference
from .resid import (MAX_COLS, WIDE_COLS, dropout_add_reference, resid_bwd_reference,
                    resid_fwd_reference)

_P, _U32, _F, _I = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int
UP_ROWS = 128       # row tile of (A) and (D): the db1 partials have ceil(N / 128) rows


def kernel_takes(hidden: int, ffn: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take a sublayer of ``hidden`` and ``ffn`` widths in ``dtype``:
    float32 or bfloat16, both widths multiples of 8 (16-byte rows), the hidden size at most
    1024 or in :data:`.resid.WIDE_COLS` (K2's rows): wav2vec2-base's 768 / 3072,
    wav2vec2-large's 1024 / 4096, XLS-R 1B's 1280 / 5120, the test config's 32 / 64. The
    wrappers raise on anything else."""
    return (dtype in DTYPE_CODES and (0 < hidden <= MAX_COLS or hidden in WIDE_COLS)
            and hidden % 8 == 0 and ffn > 0 and ffn % 8 == 0)


def ffn_mega_fwd_reference(x, w1, b1, w2, b2, weight, bias, seed: int, s_act: int, s_hid: int,
                           rate_act: float, rate_hid: float, eps: float, r=None):
    """Plain forward over ``[N, D]`` rows: ``(y, s, pre)``, each in ``x.dtype``. With ``r``
    (the pre-norm form) the residual is ``r`` in place of ``x``."""
    pre = F.linear(x, w1, b1)
    h = ffn_act_fwd_reference(pre, seed, s_act, rate_act)
    y, s = resid_fwd_reference(F.linear(h, w2, b2), x if r is None else r, weight, bias, seed,
                               s_hid, rate_hid, eps)
    return y, s, pre


def ffn_mega_bwd_reference(g, s, pre, w2, weight, seed: int, s_act: int, s_hid: int,
                           rate_act: float, rate_hid: float, eps: float, g_stream=None):
    """Plain backward without the three large products: ``(ds, dhid, dpre, h, db1, db2,
    dweight, dbias)``. ``dh = dhid W2`` is rounded to the compute dtype, as the decomposed
    route materialises it; db2 is that route's bias gradient (a sum in the compute dtype).
    With ``g_stream`` (the pre-norm form) that gradient of ``s`` is added to ``ds``."""
    dhid, ds, dweight, dbias = resid_bwd_reference(g, s, weight, seed, s_hid, rate_hid, eps,
                                                   g_stream)
    dh = dhid @ w2
    dpre, db1 = ffn_act_bwd_reference(dh, pre, seed, s_act, rate_act)
    h = ffn_act_fwd_reference(pre, seed, s_act, rate_act)
    return ds, dhid, dpre, h, db1, dhid.sum(0), dweight, dbias


def ffn_up_reference(x, w1, b1, seed: int, s_act: int, rate_act: float):
    """Plain (A): ``(pre, h)``, the first product with its bias and the dropped activation."""
    pre = F.linear(x, w1, b1)
    return pre, ffn_act_fwd_reference(pre, seed, s_act, rate_act)


def ffn_down_reference(h, w2, b2, x, seed: int, s_hid: int, rate_hid: float):
    """Plain (B): ``s = round(x + dropout(h W2^T + b2))``; the row LayerNorm follows."""
    return dropout_add_reference(F.linear(h, w2, b2), x, seed, s_hid, rate_hid)


def ffn_dgrad_reference(dhid, w2, pre, seed: int, s_act: int, rate_act: float):
    """Plain (D): ``(dpre, h, db1)`` from ``dh = round(dhid W2)``, ``h`` recomputed from
    ``pre``; db1 is float32."""
    dpre, db1 = ffn_act_bwd_reference(dhid @ w2, pre, seed, s_act, rate_act)
    return dpre, ffn_act_fwd_reference(pre, seed, s_act, rate_act), db1


def _check(name: str, rows_like: torch.Tensor, f: int, *vectors: torch.Tensor) -> tuple[int, int]:
    """(rows, hidden size) of ``[N, D]`` rows whose widths :func:`kernel_takes`."""
    if rows_like.dim() != 2 or not kernel_takes(rows_like.shape[1], f, rows_like.dtype):
        raise ValueError(f"{name}: takes [N, D] rows and an FFN width F, multiples of 8 with D "
                         f"at most {MAX_COLS} or in {WIDE_COLS}, got {tuple(rows_like.shape)} "
                         f"and {f}")
    d = rows_like.shape[1]
    for v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (d,):
            raise ValueError(f"{name}: LayerNorm parameters must be float32 [{d}]")
    return rows_like.shape[0], d


def _same(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """One dtype, and the layout the TMA loads and 16-byte accesses take: bases and row
    strides that are multiples of 16 bytes (checked before any CUDA call)."""
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: every tensor but the LayerNorm parameters must be {dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor bases must be 16-byte aligned")
        if t.dim() == 2 and t.stride(0) * t.element_size() % 16:
            raise ValueError(f"{name}: row strides must be multiples of 16 bytes, got "
                             f"{t.stride(0) * t.element_size()}")


def _fwd(name, x, r, w1, b1, w2, b2, weight, bias, seed: int, s_act: int, s_hid: int,
         rate_act: float, rate_hid: float, eps: float):
    f = w1.shape[0]
    rows, d = _check(name, x, f, weight, bias)
    if tuple(w1.shape) != (f, d) or tuple(w2.shape) != (d, f):
        raise ValueError(f"{name}: w1 must be [F, {d}] and w2 [{d}, F]")
    tensors = (x, w1, b1, w2, b2) if r is None else (x, r, w1, b1, w2, b2)
    if r is not None and r.shape != x.shape:
        raise ValueError(f"{name}: the residual must be [N, {d}] like x")
    _same(name, x.dtype, *tensors)
    check_cuda(name, *tensors, weight, bias)
    pre = x.new_empty((rows, f))
    h = torch.empty_like(pre)
    s, y = torch.empty_like(x), torch.empty_like(x)
    ptrs = (x.data_ptr(),) if r is None else (x.data_ptr(), r.data_ptr())
    entry = "ffn_mega_fwd" if r is None else "ffn_prenorm_fwd"
    fn = build.entry("ffn_mega", entry,
                     (_P,) * (10 + len(ptrs)) + (_I, _I, _I) + (_U32,) * 5 + (_F, _F, _F, _I, _P))
    build.check(fn(*ptrs, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), pre.data_ptr(), h.data_ptr(),
                   s.data_ptr(), y.data_ptr(), rows, d, f, seed, s_act, s_hid,
                   philox.threshold(rate_act), philox.threshold(rate_hid),
                   philox.keep_scale(rate_act), philox.keep_scale(rate_hid), eps,
                   DTYPE_CODES[x.dtype], build.stream(x)), name)
    return y, s, pre


def ffn_mega_fwd_kernel(x, w1, b1, w2, b2, weight, bias, seed: int, s_act: int, s_hid: int,
                        rate_act: float, rate_hid: float, eps: float):
    """Launch the forward of ``csrc/ffn_mega.cu`` ((A), (B) and the row LayerNorm); counts
    calls in ``.launches``. ``x`` is ``[N, D]``; the weights are ``nn.Linear``'s
    ``[out, in]``."""
    out = _fwd("ffn_mega_fwd_kernel", x, None, w1, b1, w2, b2, weight, bias, seed, s_act, s_hid,
               rate_act, rate_hid, eps)
    ffn_mega_fwd_kernel.launches += 1
    return out


def ffn_prenorm_fwd_kernel(x, r, w1, b1, w2, b2, weight, bias, seed: int, s_act: int,
                           s_hid: int, rate_act: float, rate_hid: float, eps: float):
    """Launch the pre-norm forward of ``csrc/ffn_mega.cu`` ((A) on ``x``, (B) adding to the
    residual ``r``, the next row LayerNorm); counts calls in ``.launches`` and
    ``ffn.prenorm.launches``. Returns ``(y, s, pre)``."""
    out = _fwd("ffn_prenorm_fwd_kernel", x, r, w1, b1, w2, b2, weight, bias, seed, s_act, s_hid,
               rate_act, rate_hid, eps)
    ffn_prenorm_fwd_kernel.launches += 1
    count("ffn.prenorm.launches")
    return out


@functools.cache
def _row_blocks(rows: int, d: int, dtype: torch.dtype, device: torch.device,
                prenorm: bool = False) -> int:
    """(C)'s persistent grid (K2's backward row pass, ``csrc/resid.cuh``; its pre-norm form
    with ``prenorm``) on ``device``: the dgamma, dbeta and db2 partials have this many rows."""
    entry = "ffn_prenorm_row_blocks" if prenorm else "ffn_mega_row_blocks"
    fn = build.entry("ffn_mega", entry, (_I, _I, _I, _I))
    blocks = fn(rows, d, sm_count(device), DTYPE_CODES[dtype])
    if blocks <= 0:
        raise RuntimeError(f"ffn_mega_row_blocks: no grid for {rows} rows of {d} in {dtype}")
    return blocks


def _bwd(name, g, gs, s, pre, w2, weight, seed: int, s_act: int, s_hid: int,
         rate_act: float, rate_hid: float, eps: float):
    f = pre.shape[-1]
    rows, d = _check(name, g, f, weight)
    if s.shape != g.shape or tuple(pre.shape) != (rows, f) or tuple(w2.shape) != (d, f) or \
            (gs is not None and gs.shape != g.shape):
        raise ValueError(f"{name}: g, s [N, {d}], pre [N, F] and w2 [{d}, F]")
    rows_like = (g, s, pre, w2) if gs is None else (g, gs, s, pre, w2)
    _same(name, g.dtype, *rows_like)
    check_cuda(name, *rows_like, weight)
    row_blocks = _row_blocks(rows, d, g.dtype, g.device, gs is not None)
    ds, dhid = torch.empty_like(g), torch.empty_like(g)
    dpre, h = torch.empty_like(pre), torch.empty_like(pre)
    parts = torch.empty((3, row_blocks, d), dtype=torch.float32, device=g.device)
    db1_parts = torch.empty((-(-rows // UP_ROWS), f), dtype=torch.float32, device=g.device)
    ptrs = (g.data_ptr(),) if gs is None else (g.data_ptr(), gs.data_ptr())
    entry = "ffn_mega_bwd" if gs is None else "ffn_prenorm_bwd"
    fn = build.entry("ffn_mega", entry,
                     (_P,) * (12 + len(ptrs)) + (_I, _I, _I) + (_U32,) * 5
                     + (_F, _F, _F, _I, _I, _P))
    build.check(fn(*ptrs, s.data_ptr(), pre.data_ptr(), w2.data_ptr(), weight.data_ptr(),
                   ds.data_ptr(), dhid.data_ptr(), dpre.data_ptr(), h.data_ptr(),
                   parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
                   db1_parts.data_ptr(), rows, d, f, seed, s_act, s_hid,
                   philox.threshold(rate_act), philox.threshold(rate_hid),
                   philox.keep_scale(rate_act), philox.keep_scale(rate_hid), eps, row_blocks,
                   DTYPE_CODES[g.dtype], build.stream(g)), name)
    dweight, dbias, db2 = parts.sum(dim=1)
    return ds, dhid, dpre, h, db1_parts.sum(0), db2, dweight, dbias


def ffn_mega_bwd_kernel(g, s, pre, w2, weight, seed: int, s_act: int, s_hid: int,
                        rate_act: float, rate_hid: float, eps: float):
    """Launch the backward of ``csrc/ffn_mega.cu`` ((C) then (D)); counts calls in
    ``.launches``. Returns what :func:`ffn_mega_bwd_reference` returns; the vector
    gradients are float32."""
    out = _bwd("ffn_mega_bwd_kernel", g, None, s, pre, w2, weight, seed, s_act, s_hid,
               rate_act, rate_hid, eps)
    ffn_mega_bwd_kernel.launches += 1
    return out


def ffn_prenorm_bwd_kernel(g, g_stream, s, pre, w2, weight, seed: int, s_act: int, s_hid: int,
                           rate_act: float, rate_hid: float, eps: float):
    """Launch the pre-norm backward of ``csrc/ffn_mega.cu`` (``g`` the gradient of ``y``,
    ``g_stream`` that of ``s``); counts calls in ``.launches`` and ``ffn.prenorm.launches``.
    Returns what :func:`ffn_mega_bwd_reference` returns with ``g_stream``."""
    out = _bwd("ffn_prenorm_bwd_kernel", g, g_stream, s, pre, w2, weight, seed, s_act, s_hid,
               rate_act, rate_hid, eps)
    ffn_prenorm_bwd_kernel.launches += 1
    count("ffn.prenorm.launches")
    return out


ffn_mega_fwd_kernel.launches = 0
ffn_mega_bwd_kernel.launches = 0
ffn_prenorm_fwd_kernel.launches = 0
ffn_prenorm_bwd_kernel.launches = 0


class _FfnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, weight, bias, seed, s_act, s_hid, rate_act, rate_hid,
                eps):
        args = (seed, s_act, s_hid, rate_act, rate_hid, eps)
        x2 = x.reshape(-1, x.shape[-1])
        if on_card(x):
            y, s, pre = ffn_mega_fwd_kernel(x2.contiguous(), w1.contiguous(), b1, w2.contiguous(),
                                            b2, weight, bias, *args)
        else:
            y, s, pre = ffn_mega_fwd_reference(x2, w1, b1, w2, b2, weight, bias, *args)
        ctx.save_for_backward(x2, w1, w2, weight, s, pre)
        ctx.args = args
        ctx.dtypes = (b1.dtype, b2.dtype)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, w1, w2, weight, s, pre = ctx.saved_tensors
        g2 = g.reshape(s.shape)
        if on_card(g):
            ds, dhid, dpre, h, db1, db2, dweight, dbias = ffn_mega_bwd_kernel(
                g2.contiguous(), s, pre, w2.contiguous(), weight, *ctx.args)
        else:
            ds, dhid, dpre, h, db1, db2, dweight, dbias = ffn_mega_bwd_reference(
                g2, s, pre, w2, weight, *ctx.args)
        # The three large products, in the decomposed route's forms; a frozen weight (LoRA)
        # or an input that needs no gradient takes none.
        need = ctx.needs_input_grad
        dx = (dpre @ w1 + ds).reshape(g.shape) if need[0] else None
        dw1 = dpre.t() @ x2 if need[1] else None
        dw2 = dhid.t() @ h if need[3] else None
        b1_dtype, b2_dtype = ctx.dtypes
        return (dx, dw1, db1.to(b1_dtype) if need[2] else None, dw2,
                db2.to(b2_dtype) if need[4] else None, dweight if need[5] else None,
                dbias if need[6] else None, None, None, None, None, None, None)


def ffn_block(x, w1, b1, w2, b2, weight, bias, seed: int, s_act: int, s_hid: int,
              rate_act: float, rate_hid: float, eps: float = 1e-5) -> torch.Tensor:
    """``LN(x + dropout(W2 dropout(gelu(W1 x + b1)) + b2))`` over the last axis of ``x``,
    in ``x.dtype``; ``w1``/``w2`` are ``nn.Linear``'s ``[out, in]``, ``weight``/``bias`` the
    float32 LayerNorm parameters. Differentiable."""
    return _FfnBlock.apply(x, w1, b1, w2, b2, weight, bias, seed, s_act, s_hid, rate_act,
                           rate_hid, eps)


class _FfnPrenorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, w1, b1, w2, b2, weight, bias, seed, s_act, s_hid, rate_act, rate_hid,
                eps):
        args = (seed, s_act, s_hid, rate_act, rate_hid, eps)
        x2, r2 = x.reshape(-1, x.shape[-1]), r.reshape(-1, r.shape[-1])
        if on_card(x):
            y, s, pre = ffn_prenorm_fwd_kernel(x2.contiguous(), r2.contiguous(), w1.contiguous(),
                                               b1, w2.contiguous(), b2, weight, bias, *args)
        else:
            y, s, pre = ffn_mega_fwd_reference(x2, w1, b1, w2, b2, weight, bias, *args, r=r2)
        ctx.save_for_backward(x2, w1, w2, weight, s, pre)
        ctx.args = args
        ctx.dtypes = (b1.dtype, b2.dtype)
        ctx.x_shape = x.shape
        return s.reshape(x.shape), y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_stream, g):
        x2, w1, w2, weight, s, pre = ctx.saved_tensors
        g2 = torch.zeros_like(s) if g is None else g.reshape(s.shape)
        gs2 = torch.zeros_like(s) if g_stream is None else g_stream.reshape(s.shape)
        if on_card(g2):
            ds, dhid, dpre, h, db1, db2, dweight, dbias = ffn_prenorm_bwd_kernel(
                g2.contiguous(), gs2.contiguous(), s, pre, w2.contiguous(), weight, *ctx.args)
        else:
            ds, dhid, dpre, h, db1, db2, dweight, dbias = ffn_mega_bwd_reference(
                g2, s, pre, w2, weight, *ctx.args, g_stream=gs2)
        # The three large products, as in the post-norm op; the residual's gradient is ds.
        need = ctx.needs_input_grad
        dx = (dpre @ w1).reshape(ctx.x_shape) if need[0] else None
        dr = ds.reshape(ctx.x_shape) if need[1] else None
        dw1 = dpre.t() @ x2 if need[2] else None
        dw2 = dhid.t() @ h if need[4] else None
        b1_dtype, b2_dtype = ctx.dtypes
        return (dx, dr, dw1, db1.to(b1_dtype) if need[3] else None, dw2,
                db2.to(b2_dtype) if need[5] else None, dweight if need[6] else None,
                dbias if need[7] else None, None, None, None, None, None, None)


def ffn_block_prenorm(x, r, w1, b1, w2, b2, weight, bias, seed: int, s_act: int, s_hid: int,
                      rate_act: float, rate_hid: float, eps: float = 1e-5
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-norm FFN sublayer with the next LayerNorm: ``(s, LN(s))`` with the stream
    ``s = r + dropout(W2 dropout(gelu(W1 x + b1)) + b2)`` over the last axis, in ``x.dtype``;
    ``w1``/``w2`` are ``nn.Linear``'s ``[out, in]``, ``weight``/``bias`` the float32 parameters
    of the LayerNorm that follows. Differentiable in both outputs."""
    return _FfnPrenorm.apply(x, r.to(x.dtype), w1, b1, w2, b2, weight, bias, seed, s_act, s_hid,
                             rate_act, rate_hid, eps)
