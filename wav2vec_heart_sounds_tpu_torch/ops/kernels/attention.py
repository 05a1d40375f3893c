"""Attention with dropout, packed (K3b) and unpacked (K3a): the CUDA kernels, their plain
versions, autograd.

Ports of ``wav2vec_heart_sounds_tpu/ops/pallas/attention.py``: ``flash_attention_qkv`` (K3b,
the encoder's default packed-QKV route) and ``flash_attention`` (K3a, the unpacked route of
``Wav2Vec2Config.qkv_fuse=False``, the JAX package's ``W2VHS_NO_QKVFUSE=1``). K3a computes
exactly K3b's function, and both run one pair of CUDA kernel bodies
(``csrc/attention_qkv_fwd.cu``, ``csrc/attention_qkv_bwd.cu``) that take every tensor as a
base pointer and element strides over (b, h, t): K3b passes the three head ranges of one
packed tensor (the encoder's is the head view of its ``[B, T, 3H, d]`` projection, no
copy), K3a three ``[B, H, T, d]`` views (the head views of the ``[B, T, D]`` projections);
both get their output as the head view of a ``[B, T, H, d]`` tensor, so the caller's
``[B, T, D]`` reshape is free, and their gradients in the strides of their inputs. The
kernels stage rows with 16-byte copies: a view whose base or (b, h, t) byte strides are not
multiples of 16 raises.

Layouts are the JAX package's: K3b's input ``[B, 3H, T, d]`` with heads ``0..H-1`` = Q,
``H..2H-1`` = K, ``2H..3H-1`` = V; K3a's q, k, v ``[B, H, T, d]``; the output
``[B, H, T, d]``. Keys at positions ``>= t`` are masked. Scores and softmax are float32;
the output has the input dtype.

Attention dropout drops the normalised probabilities with the Philox mask of
``(seed, site)`` at element index ``((b*H + h)*T + q)*T + k`` (:mod:`..philox`), on both
routes, so the packed and unpacked routes draw the same masks and give the same numbers. The
forward also returns the row log-sum-exp (float32 ``[B, H, T]``); the backward recomputes the
probabilities from it, regenerates the mask, takes ``D = rowsum(dO * O)`` and returns the
gradients of q, k and v (packed ``[B, 3H, T, d]`` for K3b).

:func:`flash_attention_qkv` and :func:`flash_attention` are the eval forwards (rate 0, no
autograd); :func:`attention_qkv_train` and :func:`attention_train` the differentiable
training ops. All take the plain versions only for CPU tensors; CUDA tensors go to the
kernels, built for the head dims :func:`kernel_takes` names, or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import philox
from . import build
from .dropout import on_card

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The head widths the kernels are built for (one instantiation each): wav2vec2-base's and
# -large's 64, XLS-R 1B's 80, the test config's 16.
HEAD_DIMS = (16, 32, 64, 80, 128)
_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float


def kernel_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take heads of ``head_dim`` in ``dtype``: a head dim they are built
    for, float32 or bfloat16. The wrappers raise on anything else, and on views whose rows are
    not 16-byte aligned."""
    return dtype in _DTYPE_CODES and head_dim in HEAD_DIMS


def _split(qkv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q, k and v head ranges of a packed ``[B, 3H, T, d]`` tensor (views)."""
    h = qkv.shape[1] // 3
    return qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]


def _scores(q, k, t: int, T: int) -> torch.Tensor:
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if t < T:
        scores = scores.masked_fill(torch.arange(T, device=q.device) >= t, float("-inf"))
    return scores


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        t: int | None = None, rate: float = 0.0, seed: int = 0, site: int = 0,
                        with_lse: bool = False):
    """Plain PyTorch forward over ``[B, H, T, d]`` q, k, v: f32 einsum, key mask, softmax,
    dropout of the probabilities, PV; output in the input dtype. ``with_lse`` also returns
    the row log-sum-exp."""
    T = q.shape[2]
    t = T if t is None else t
    scores = _scores(q.float(), k.float(), t, T)
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = philox.keep_mask(seed, site, probs.shape, rate, q.device)
        probs = torch.where(keep, probs * philox.keep_scale(rate), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if with_lse else out


def attention_bwd_reference(q, k, v, out, dout, lse, t: int | None = None, rate: float = 0.0,
                            seed: int = 0, site: int = 0):
    """Plain PyTorch backward (the kernels' formulas): ``(dq, dk, dv)`` in the input dtype."""
    T, d, dtype = q.shape[2], q.shape[3], q.dtype
    t = T if t is None else t
    q, k, v, do = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(_scores(q, k, t, T) - lse[..., None])
    keep = philox.keep_mask(seed, site, p.shape, rate, q.device)
    c = philox.keep_scale(rate)
    dp = torch.where(keep, torch.einsum("bhqd,bhkd->bhqk", do, v) * c, 0.0)
    ds = p * (dp - (do * out.float()).sum(dim=-1, keepdim=True))
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", torch.where(keep, p * c, 0.0), do)
    return tuple(g.to(dtype) for g in (dq, dk, dv))


def attention_qkv_reference(qkv: torch.Tensor, t: int | None = None, rate: float = 0.0,
                            seed: int = 0, site: int = 0, with_lse: bool = False):
    """:func:`attention_reference` on the q, k and v of a packed ``[B, 3H, T, d]`` tensor."""
    return attention_reference(*_split(qkv), t, rate, seed, site, with_lse)


def attention_qkv_bwd_reference(qkv, out, dout, lse, t: int | None = None, rate: float = 0.0,
                                seed: int = 0, site: int = 0) -> torch.Tensor:
    """:func:`attention_bwd_reference` packed: ``dqkv [B, 3H, T, d]`` in the input dtype."""
    return torch.cat(attention_bwd_reference(*_split(qkv), out, dout, lse, t, rate, seed, site),
                     dim=1)


def _aligned(x: torch.Tensor) -> bool:
    """The kernels stage rows with 16-byte ``cp.async`` copies: the base pointer and the
    (b, h, t) byte strides must be multiples of 16."""
    return x.data_ptr() % 16 == 0 and all(s * x.element_size() % 16 == 0 for s in x.stride()[:3])


def _check(name: str, t: int, *views: torch.Tensor) -> None:
    """Every view is a CUDA ``[B, H, T, d]`` tensor of one shape and dtype, d one of
    :data:`HEAD_DIMS` and contiguous, its rows 16-byte aligned."""
    first = views[0]
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {first.dtype}")
    if first.ndim != 4 or not kernel_takes(first.shape[3], first.dtype):
        raise ValueError(f"{name}: expected [B, H, T, d] views with d in {HEAD_DIMS}, got "
                         f"{tuple(first.shape)}")
    if not first.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors, got {first.device}")
    for x in views:
        if x.shape != first.shape or x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"{name}: every view must be {tuple(first.shape)} {first.dtype} "
                             f"on {first.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head dim of every view must be contiguous")
        if not _aligned(x):
            raise ValueError(f"{name}: every view needs a 16-byte aligned base and (b, h, t) "
                             f"byte strides that are multiples of 16, got pointer "
                             f"{x.data_ptr()} and strides {x.stride()} of "
                             f"{x.element_size()}-byte elements")
    if not 1 <= t <= first.shape[2]:
        raise ValueError(f"key count t={t} outside [1, T={first.shape[2]}]")


def _strides(*views: torch.Tensor):
    """The (b, h, t) element strides of each view, flattened, as the C entries take them."""
    flat = [s for x in views for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_fwd(name: str, q, k, v, out, lse, t: int, rate: float, seed: int, site: int):
    B, H, T, d = q.shape
    fn = build.entry("attention_qkv_fwd", "attention_fwd",
                     (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U32, _U32, _U32, _F, _I,
                      _P))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if lse is not None else None, _strides(q, k, v, out),
                   B, H, T, d, t, 1.0 / math.sqrt(d), seed, site, philox.threshold(rate),
                   philox.keep_scale(rate), _DTYPE_CODES[q.dtype], build.stream(q)), name)


def _launch_bwd(name: str, q, k, v, out, dout, lse, dq, dk, dv, t: int, rate: float,
                seed: int, site: int):
    B, H, T, d = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous float32 [B, H, T]")
    fn = build.entry("attention_qkv_bwd", "attention_bwd",
                     (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U32,
                      _U32, _U32, _F, _I, _P))
    dsum = torch.empty_like(lse)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                   lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   _strides(q, k, v, out, dout, dq, dk, dv), B, H, T, d, t, 1.0 / math.sqrt(d),
                   seed, site, philox.threshold(rate), philox.keep_scale(rate),
                   _DTYPE_CODES[q.dtype], build.stream(q)), name)


def _lse_or_none(q: torch.Tensor, with_lse: bool):
    B, H, T, _ = q.shape
    return torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None


def attention_qkv_fwd(qkv: torch.Tensor, t: int | None = None, rate: float = 0.0,
                      seed: int = 0, site: int = 0, with_lse: bool = False):
    """K3b: launch the forward kernel on the packed tensor's three head ranges (any strides
    the kernel takes: a contiguous ``[B, 3H, T, d]`` or the head view of a
    ``[B, T, 3H, d]`` projection), on the current stream; counts launches in ``.launches``.
    ``out`` is the head view of a ``[B, T, H, d]`` tensor, so the caller's ``[B, T, D]``
    reshape is free; returns ``out``, or ``(out, lse)`` with ``with_lse``."""
    T = qkv.shape[2]
    t = T if t is None else int(t)
    if qkv.ndim != 4 or qkv.shape[1] % 3:
        raise ValueError(f"expected packed [B, 3H, T, d], got {tuple(qkv.shape)}")
    q, k, v = _split(qkv)
    _check("attention_qkv_fwd", t, q, k, v)
    out = _heads_of_bthd(q)
    lse = _lse_or_none(q, with_lse)
    _launch_fwd("attention_qkv_fwd", q, k, v, out, lse, t, rate, seed, site)
    attention_qkv_fwd.launches += 1
    return (out, lse) if with_lse else out


def attention_qkv_bwd(qkv, out, dout, lse, t: int | None = None, rate: float = 0.0,
                      seed: int = 0, site: int = 0) -> torch.Tensor:
    """K3b: launch the backward kernels on the current stream, writing the three head ranges
    of one packed ``dqkv`` with the strides of ``qkv``; counts calls in ``.launches``."""
    T = qkv.shape[2]
    t = T if t is None else int(t)
    if qkv.ndim != 4 or qkv.shape[1] % 3:
        raise ValueError(f"expected packed [B, 3H, T, d], got {tuple(qkv.shape)}")
    q, k, v = _split(qkv)
    _check("attention_qkv_bwd", t, q, k, v, out, dout)
    dqkv = torch.empty_like(qkv)
    _launch_bwd("attention_qkv_bwd", q, k, v, out, dout, lse, *_split(dqkv), t, rate, seed, site)
    attention_qkv_bwd.launches += 1
    return dqkv


def _heads_of_bthd(like: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[B, T, H, d]`` tensor, returned as its ``[B, H, T, d]`` head view."""
    B, H, T, d = like.shape
    return torch.empty((B, T, H, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: int | None = None,
                  rate: float = 0.0, seed: int = 0, site: int = 0, with_lse: bool = False):
    """K3a: launch the forward kernel on ``[B, H, T, d]`` views (any strides, d contiguous)
    on the current stream; counts launches in ``.launches``. ``out`` is the head view of a
    ``[B, T, H, d]`` tensor; returns ``out``, or ``(out, lse)`` with ``with_lse``."""
    T = q.shape[2]
    t = T if t is None else int(t)
    _check("attention_fwd", t, q, k, v)
    out = _heads_of_bthd(q)
    lse = _lse_or_none(q, with_lse)
    _launch_fwd("attention_fwd", q, k, v, out, lse, t, rate, seed, site)
    attention_fwd.launches += 1
    return (out, lse) if with_lse else out


def attention_bwd(q, k, v, out, dout, lse, t: int | None = None, rate: float = 0.0,
                  seed: int = 0, site: int = 0):
    """K3a: launch the backward kernels on the current stream; counts calls in
    ``.launches``. Returns ``(dq, dk, dv)``, each the head view of a ``[B, T, H, d]``
    tensor."""
    T = q.shape[2]
    t = T if t is None else int(t)
    _check("attention_bwd", t, q, k, v, out, dout)
    grads = tuple(_heads_of_bthd(q) for _ in range(3))
    _launch_bwd("attention_bwd", q, k, v, out, dout, lse, *grads, t, rate, seed, site)
    attention_bwd.launches += 1
    return grads


attention_qkv_fwd.launches = 0
attention_qkv_bwd.launches = 0
attention_fwd.launches = 0
attention_bwd.launches = 0


def flash_attention_qkv(qkv: torch.Tensor, t: int | None = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Eval attention over a packed ``[B, 3H, T, d]`` tensor -> ``[B, H, T, d]``.

    CPU tensors take :func:`attention_qkv_reference`; CUDA tensors the kernel.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) runs in training, through "
            "attention_qkv_train(qkv, t, rate, seed, site)")
    if on_card(qkv):
        return attention_qkv_fwd(qkv, t)
    return attention_qkv_reference(qkv, t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: int | None = None,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """Eval attention over ``[B, H, T, d]`` q, k, v -> ``[B, H, T, d]``.

    CPU tensors take :func:`attention_reference`; CUDA tensors the kernel.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) runs in training, through "
            "attention_train(q, k, v, t, rate, seed, site)")
    if on_card(q):
        return attention_fwd(q, k, v, t)
    return attention_reference(q, k, v, t)


def _dense_dout(dout: torch.Tensor) -> torch.Tensor:
    # autograd may hand over a view whose head dim is strided or whose rows are misaligned
    return dout if dout.stride(3) == 1 and _aligned(dout) else dout.contiguous()


class _AttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, t, rate, seed, site):
        args = (t, rate, seed, site)
        if on_card(qkv):
            out, lse = attention_qkv_fwd(qkv, *args, with_lse=True)
        else:
            out, lse = attention_qkv_reference(qkv, *args, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        if on_card(dout):
            dqkv = attention_qkv_bwd(qkv, out, _dense_dout(dout), lse, *ctx.args)
        else:
            dqkv = attention_qkv_bwd_reference(qkv, out, dout, lse, *ctx.args)
        return dqkv, None, None, None, None


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, t, rate, seed, site):
        args = (t, rate, seed, site)
        fwd = attention_fwd if on_card(q) else attention_reference
        out, lse = fwd(q, k, v, *args, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if on_card(dout):
            grads = attention_bwd(q, k, v, out, _dense_dout(dout), lse, *ctx.args)
        else:
            grads = attention_bwd_reference(q, k, v, out, dout, lse, *ctx.args)
        return (*grads, None, None, None, None)


def attention_qkv_train(qkv: torch.Tensor, t: int | None, rate: float, seed: int,
                        site: int) -> torch.Tensor:
    """Differentiable packed training attention (dropout ``rate`` at ``(seed, site)``) ->
    ``[B, H, T, d]``."""
    return _AttentionQKV.apply(qkv, qkv.shape[2] if t is None else t, rate, seed, site)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: int | None,
                    rate: float, seed: int, site: int) -> torch.Tensor:
    """Differentiable unpacked training attention over ``[B, H, T, d]`` views (dropout
    ``rate`` at ``(seed, site)``) -> ``[B, H, T, d]``; the same masks as
    :func:`attention_qkv_train` on the packed tensor of the same q, k and v."""
    return _Attention.apply(q, k, v, q.shape[2] if t is None else t, rate, seed, site)
