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
tensors; CUDA tensors go to ``csrc/conv_gelu.cu`` or raise. In bfloat16 the forward packs x
once into the JAX kernel's frame view (:func:`pack_frames_reference`: ``xf [B, out_len + 1,
2 Cin]``, channels last) and runs a GEMM on it with the weight re-laid as
:func:`relay_weight`; the backward reads that frame view (saved in place of x), writes
``dpre`` channels last with the frame axis padded (:func:`dpre_frames_reference`), and runs
the ``dx`` and ``dW`` GEMMs (``dW`` as float32 partials reduced in a second pass). Float32
keeps its own kernels (forward; ``dpre``, ``dx``, ``dW`` partials and their reduction) on
x itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import gelu
from . import build
from .dropout import check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
CHANNEL_TILE = 128      # Cin and Cout must be multiples of it
MAX_PARTS = 32          # float32 dW partials: at most this many row ranges of B * out_len
ROWS_PER_PART = 4096    # and at least this many rows each
FRAME_STEP = 64         # bfloat16: the frame axis of dpre is padded to a multiple of it


def _ptr(a: torch.Tensor | None):
    return a.data_ptr() if a is not None else None


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


def relay_weight(w: torch.Tensor) -> torch.Tensor:
    """``w [Cout, Cin, 3]`` re-laid as ``wr [Cout, 3 Cin]`` with ``k = tap * Cin + c``: the
    bfloat16 forward's A operand (a copy)."""
    return w.permute(0, 2, 1).reshape(w.shape[0], 3 * w.shape[1])


def relay_weight_dx(w: torch.Tensor) -> torch.Tensor:
    """``w [Cout, Cin, 3]`` re-laid for the bfloat16 dx GEMM as ``[Cin / 64][3][64][Cout]``
    (``[3 Cin, Cout]``): row ``192 m + 64 j + i`` is tap j of channel ``64 m + i`` (a copy)."""
    cout, cin, _ = w.shape
    return (w.permute(1, 2, 0).reshape(cin // 64, 64, 3, cout).permute(0, 2, 1, 3)
            .reshape(3 * cin, cout))


def pack_frames_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain frame view of ``x [B, Cin, T]``: ``xf [B, out_len + 1, 2 Cin]`` with
    ``xf[b, u, j * Cin + c] = x[b, c, 2u + j]`` and zeros past T. Row ``out_len`` holds
    ``x[2 out_len]``, the last frame's tap-2 input; frame u's three taps are row u and the
    first Cin of row u + 1."""
    B, cin, t = x.shape
    frames = out_length(t) + 1
    padded = F.pad(x, (0, 2 * frames - t))
    return padded.reshape(B, cin, frames, 2).permute(0, 2, 3, 1).reshape(B, frames, 2 * cin)


def frames_padded(out_len: int) -> int:
    """Rows of one batch of the bfloat16 backward's ``dpre``: ``out_len + 1`` rounded up to
    a multiple of :data:`FRAME_STEP`."""
    return -(-(out_len + 1) // FRAME_STEP) * FRAME_STEP


def dpre_frames_reference(pre: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain padded ``dpre`` of the bfloat16 backward: ``round(g * gelu'(pre))`` (as in
    :func:`conv_gelu_bwd_reference`) laid out ``[B, frames_padded(out_len), Cout]``, channels
    last, zero from frame ``out_len`` on."""
    B, cout, out_len = pre.shape
    dpre = (g.float() * gelu.gelu_erf_grad(pre)).to(pre.dtype)
    out = torch.zeros((B, frames_padded(out_len), cout), dtype=pre.dtype, device=pre.device)
    out[:, :out_len] = dpre.transpose(1, 2)
    return out


class ConvFrames(NamedTuple):
    """What the bfloat16 CUDA forward saves for its backward in place of ``x``: the frame view
    ``xf`` (:func:`pack_frames_reference`) and x's length ``t``."""
    xf: torch.Tensor
    t: int


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


def _frames_check(name: str, x: ConvFrames, w: torch.Tensor):
    check_cuda(name, x.xf, w)
    B, frames, cin2 = x.xf.shape
    cout, cin = w.shape[0], w.shape[1]
    out_len = out_length(x.t)
    if x.xf.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or cin2 != 2 * cin or \
            frames != out_len + 1 or cin % CHANNEL_TILE or cout % CHANNEL_TILE:
        raise ValueError(f"{name}: expected a bfloat16 frame view [B, out_len + 1, 2 Cin] of "
                         f"T = {x.t} and w [Cout, Cin, 3], got {tuple(x.xf.shape)} and "
                         f"{tuple(w.shape)}")
    return B, cin, x.t, cout, out_len


def _pack(x: torch.Tensor) -> ConvFrames:
    """The pack pass of ``csrc/conv_gelu.cu`` (bfloat16): x's frame view."""
    B, cin, t = x.shape
    out_len = out_length(t)
    xf = torch.empty((B, out_len + 1, 2 * cin), dtype=x.dtype, device=x.device)
    fn = build.entry("conv_gelu", "conv_gelu_pack_bf16", (_P, _P, _I, _I, _I, _I, _P))
    build.check(fn(x.data_ptr(), xf.data_ptr(), B, cin, t, out_len, build.stream(x)),
                "conv_gelu pack")
    return ConvFrames(xf, t)


def _fwd_frames(x: ConvFrames, wr: torch.Tensor, out: torch.Tensor, pre: torch.Tensor) -> None:
    """The bfloat16 forward GEMM of ``csrc/conv_gelu.cu`` on a frame view, ``wr`` from
    :func:`relay_weight`."""
    B, _, cin2 = x.xf.shape
    fn = build.entry("conv_gelu", "conv_gelu_fwd_bf16", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P))
    build.check(fn(x.xf.data_ptr(), wr.data_ptr(), out.data_ptr(), pre.data_ptr(), B, cin2 // 2,
                   x.t, wr.shape[0], out.shape[2], build.stream(out)), "conv_gelu_fwd_kernel")


def conv_gelu_fwd_kernel(x: torch.Tensor, w: torch.Tensor, *, keep_frames: bool = False):
    """Launch the forward of ``csrc/conv_gelu.cu`` (bfloat16: the pack pass and the GEMM);
    counts launches in ``.launches``. Returns ``(out, pre)``, each ``[B, Cout, out_len]`` in
    ``x.dtype``; with ``keep_frames`` also what :func:`conv_gelu_bwd_kernel` then takes in
    place of x: the frame view as :class:`ConvFrames` in bfloat16, x itself in float32."""
    B, cin, t, cout, out_len = _check("conv_gelu_fwd_kernel", x, w)
    out = torch.empty((B, cout, out_len), dtype=x.dtype, device=x.device)
    pre = torch.empty_like(out)
    st = build.stream(x)
    if x.dtype == torch.bfloat16:
        saved = _pack(x)
        _fwd_frames(saved, relay_weight(w), out, pre)
    else:
        fn = build.entry("conv_gelu", "conv_gelu_fwd_f32",
                         (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P))
        build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), pre.data_ptr(), B, cin, t,
                       cout, out_len, st), "conv_gelu_fwd_kernel")
        saved = x
    conv_gelu_fwd_kernel.launches += 1
    return (out, pre, saved) if keep_frames else (out, pre)


def dw_parts(B: int, out_len: int, cin: int, cout: int, device: torch.device) -> int:
    """The bfloat16 dW's float32 partials: ranges of (batch, 64-frame) k steps such that
    ranges x output tiles fill whole waves of the card's SMs (11 at conv_1 on 132 SMs: 528
    tiles), at most one a k step."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = (cout // 128) * (3 * cin // 128)
    parts = sms // math.gcd(sms, tiles)
    while parts * tiles < 2 * sms:
        parts *= 2
    return max(1, min(parts, B * frames_padded(out_len) // FRAME_STEP))


def _dpre_frames(pre: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bfloat16 backward's ``dpre`` pass alone (:func:`dpre_frames_reference` on the card),
    for checks and timings."""
    B, cout, out_len = pre.shape
    dpre_t = torch.empty((B, frames_padded(out_len), cout), dtype=pre.dtype, device=pre.device)
    _bwd_bf16(None, None, pre, g, dpre_t, None, None, None, 2 * out_len + 1, CHANNEL_TILE, 1,
              False, False)
    return dpre_t


def _bwd_bf16(xf, wx, pre, g, dpre_t, dx, parts, dw, t, cin, n_parts, need_dx, need_dw):
    B, cout, out_len = pre.shape
    fn = build.entry("conv_gelu", "conv_gelu_bwd_bf16",
                     (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P))
    build.check(fn(_ptr(xf), _ptr(wx), pre.data_ptr(), g.data_ptr(), dpre_t.data_ptr(),
                   _ptr(dx), _ptr(parts), _ptr(dw), B, cin, t, cout, out_len, dpre_t.shape[1],
                   n_parts, int(need_dx), int(need_dw), build.stream(pre)),
                "conv_gelu_bwd_kernel")


def conv_gelu_bwd_kernel(x, w: torch.Tensor, pre: torch.Tensor, g: torch.Tensor,
                         need_dx: bool = True, need_dw: bool = True):
    """Launch the backward of ``csrc/conv_gelu.cu`` (``dpre``, then ``dx`` and the ``dW``
    partials and their reduction, each where needed); counts calls in ``.launches``. ``x`` is
    the input, or what the forward kept (:func:`conv_gelu_fwd_kernel` with ``keep_frames``);
    in bfloat16 an input x is packed first. Returns ``(dx, dw)`` (``None`` where not
    needed)."""
    name = "conv_gelu_bwd_kernel"
    if isinstance(x, ConvFrames):
        B, cin, t, cout, out_len = _frames_check(name, x, w)
        dtype, device = x.xf.dtype, x.xf.device
    else:
        B, cin, t, cout, out_len = _check(name, x, w)
        dtype, device = x.dtype, x.device
    check_cuda(name, pre, g)
    shape = (B, cout, out_len)
    if tuple(pre.shape) != shape or tuple(g.shape) != shape or {pre.dtype, g.dtype} != {dtype}:
        raise ValueError(f"{name}: pre and g must be {dtype} {list(shape)}")
    dx = torch.empty((B, cin, t), dtype=dtype, device=device) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if dtype == torch.bfloat16:
        if not isinstance(x, ConvFrames):
            x = _pack(x)
        n_parts = dw_parts(B, out_len, cin, cout, device)
        dpre_t = torch.empty((B, frames_padded(out_len), cout), dtype=dtype, device=device)
        parts = (torch.empty((n_parts, cout, 3 * cin), dtype=torch.float32, device=device)
                 if need_dw else None)
        _bwd_bf16(x.xf, relay_weight_dx(w), pre, g, dpre_t, dx, parts, dw, t, cin, n_parts,
                  need_dx, need_dw)
    else:
        n_parts = max(1, min(MAX_PARTS, B * out_len // ROWS_PER_PART))
        parts = (torch.empty((n_parts, cout, 3 * cin), dtype=torch.float32, device=device)
                 if need_dw else None)
        dpre = torch.empty_like(pre)
        wt = w.permute(2, 1, 0).reshape(3 * cin, cout)       # [3, Cin, Cout], a copy
        fn = build.entry("conv_gelu", "conv_gelu_bwd_f32",
                         (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P))
        build.check(fn(x.data_ptr(), wt.data_ptr(), pre.data_ptr(), g.data_ptr(),
                       dpre.data_ptr(), _ptr(dx), _ptr(parts), _ptr(dw), B, cin, t, cout, out_len,
                       n_parts, int(need_dx), int(need_dw), build.stream(x)), name)
    conv_gelu_bwd_kernel.launches += 1
    return dx, dw


conv_gelu_fwd_kernel.launches = 0
conv_gelu_bwd_kernel.launches = 0


class _ConvGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        if x.device.type == "cpu":
            out, pre = conv_gelu_fwd_reference(x, w)
            saved = x
        else:
            w = w.contiguous()
            out, pre, saved = conv_gelu_fwd_kernel(x.contiguous(), w, keep_frames=True)
        # bfloat16 on the card keeps the frame view (not x): the backward needs no second pack.
        ctx.t = saved.t if isinstance(saved, ConvFrames) else None
        ctx.save_for_backward(saved.xf if ctx.t is not None else saved, w, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, pre = ctx.saved_tensors
        if ctx.t is not None:
            x = ConvFrames(x, ctx.t)
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
