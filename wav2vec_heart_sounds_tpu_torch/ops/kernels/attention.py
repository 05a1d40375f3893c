"""Packed-QKV attention (K3b): the hand-written CUDA kernels, their plain versions, autograd.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/attention.py::flash_attention_qkv``.
Layouts are the JAX package's: input ``[B, 3H, T, d]`` with heads ``0..H-1`` = Q,
``H..2H-1`` = K, ``2H..3H-1`` = V; output ``[B, H, T, d]``. Keys at positions ``>= t``
are masked. Scores and softmax are float32; the output has the input dtype.

Attention dropout drops the normalised probabilities with the Philox mask of
``(seed, site)`` at element index ``((b*H + h)*T + q)*T + k`` (:mod:`..philox`). The
forward also returns the row log-sum-exp (float32 ``[B, H, T]``); the backward recomputes
the probabilities from it, regenerates the mask, takes ``D = rowsum(dO * O)`` and returns
the packed ``[B, 3H, T, d]`` gradient.

:func:`flash_attention_qkv` is the eval forward (rate 0, no autograd);
:func:`attention_qkv_train` the differentiable training op. Both take the plain versions
only for CPU tensors; CUDA tensors go to ``csrc/attention_qkv_fwd.cu`` and
``csrc/attention_qkv_bwd.cu`` or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import philox
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64   # wav2vec2-base: 768 hidden / 12 heads; the only width the kernels are built for
_P, _I, _U32, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float


def _split(qkv: torch.Tensor):
    h = qkv.shape[1] // 3
    return (qkv[:, i * h:(i + 1) * h].float() for i in range(3))


def _scores(q, k, t: int, T: int) -> torch.Tensor:
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if t < T:
        scores = scores.masked_fill(torch.arange(T, device=q.device) >= t, float("-inf"))
    return scores


def attention_qkv_reference(qkv: torch.Tensor, t: int | None = None, rate: float = 0.0,
                            seed: int = 0, site: int = 0, with_lse: bool = False):
    """Plain PyTorch forward: f32 einsum, key mask, softmax, dropout of the probabilities,
    PV; output in the input dtype. ``with_lse`` also returns the row log-sum-exp."""
    B, H3, T, d = qkv.shape
    t = T if t is None else t
    q, k, v = _split(qkv)
    scores = _scores(q, k, t, T)
    probs = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = philox.keep_mask(seed, site, probs.shape, rate, qkv.device)
        probs = torch.where(keep, probs * philox.keep_scale(rate), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v).to(qkv.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if with_lse else out


def attention_qkv_bwd_reference(qkv, out, dout, lse, t: int | None = None, rate: float = 0.0,
                                seed: int = 0, site: int = 0) -> torch.Tensor:
    """Plain PyTorch backward (the kernel's formulas): packed ``dqkv`` in the input dtype."""
    B, H3, T, d = qkv.shape
    t = T if t is None else t
    q, k, v = _split(qkv)
    do = dout.float()
    p = torch.exp(_scores(q, k, t, T) - lse[..., None])
    keep = philox.keep_mask(seed, site, p.shape, rate, qkv.device)
    c = philox.keep_scale(rate)
    dp = torch.where(keep, torch.einsum("bhqd,bhkd->bhqk", do, v) * c, 0.0)
    ds = p * (dp - (do * out.float()).sum(dim=-1, keepdim=True))
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", torch.where(keep, p * c, 0.0), do)
    return torch.cat([dq, dk, dv], dim=1).to(qkv.dtype)


def _check(qkv: torch.Tensor, t: int, name: str = "attention_qkv_fwd") -> None:
    if not qkv.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 4 or qkv.shape[1] % 3:
        raise ValueError(f"expected packed [B, 3H, T, d], got {tuple(qkv.shape)}")
    if qkv.shape[3] != HEAD_DIM:
        raise ValueError(f"head dim {qkv.shape[3]}: the kernel is built for {HEAD_DIM}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name} needs a contiguous [B, 3H, T, d] tensor")
    if not 1 <= t <= qkv.shape[2]:
        raise ValueError(f"key count t={t} outside [1, T={qkv.shape[2]}]")


def attention_qkv_fwd(qkv: torch.Tensor, t: int | None = None, rate: float = 0.0,
                      seed: int = 0, site: int = 0, with_lse: bool = False):
    """Launch the forward kernel on the current stream; counts launches in ``.launches``.
    Returns ``out``, or ``(out, lse)`` with ``with_lse``."""
    B, H3, T, d = qkv.shape
    t = T if t is None else int(t)
    _check(qkv, t)
    fn = build.entry("attention_qkv_fwd", "attention_qkv_fwd",
                     (_P, _P, _P, _I, _I, _I, _I, _I, _F, _U32, _U32, _U32, _F, _I, _P))
    out = torch.empty((B, H3 // 3, T, d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((B, H3 // 3, T), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    build.check(fn(qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                   B, H3 // 3, T, d, t, 1.0 / math.sqrt(d), seed, site,
                   philox.threshold(rate), philox.keep_scale(rate), _DTYPE_CODES[qkv.dtype],
                   build.stream(qkv)), "attention_qkv_fwd")
    attention_qkv_fwd.launches += 1
    return (out, lse) if with_lse else out


def attention_qkv_bwd(qkv, out, dout, lse, t: int | None = None, rate: float = 0.0,
                      seed: int = 0, site: int = 0) -> torch.Tensor:
    """Launch the backward kernels on the current stream; counts calls in ``.launches``."""
    B, H3, T, d = qkv.shape
    t = T if t is None else int(t)
    _check(qkv, t, "attention_qkv_bwd")
    for x, shape in ((out, (B, H3 // 3, T, d)), (dout, (B, H3 // 3, T, d))):
        if x.dtype != qkv.dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"attention_qkv_bwd: expected contiguous {shape} {qkv.dtype}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H3 // 3, T):
        raise ValueError("attention_qkv_bwd: lse must be float32 [B, H, T]")
    fn = build.entry("attention_qkv_bwd", "attention_qkv_bwd",
                     (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U32, _U32, _U32, _F, _I,
                      _P))
    dqkv = torch.empty_like(qkv)
    dsum = torch.empty_like(lse)
    build.check(fn(qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                   dsum.data_ptr(), dqkv.data_ptr(), B, H3 // 3, T, d, t, 1.0 / math.sqrt(d),
                   seed, site, philox.threshold(rate), philox.keep_scale(rate),
                   _DTYPE_CODES[qkv.dtype], build.stream(qkv)), "attention_qkv_bwd")
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_fwd.launches = 0
attention_qkv_bwd.launches = 0


def flash_attention_qkv(qkv: torch.Tensor, t: int | None = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Eval attention over a packed ``[B, 3H, T, d]`` tensor -> ``[B, H, T, d]``.

    CPU tensors take :func:`attention_qkv_reference`; CUDA tensors the kernel.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) runs in training, through "
            "attention_qkv_train(qkv, t, rate, seed, site)")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, t)
    return attention_qkv_fwd(qkv, t)


class _AttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, t, rate, seed, site):
        args = (t, rate, seed, site)
        if qkv.device.type == "cpu":
            out, lse = attention_qkv_reference(qkv, *args, with_lse=True)
        else:
            out, lse = attention_qkv_fwd(qkv.contiguous(), *args, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        if dout.device.type == "cpu":
            dqkv = attention_qkv_bwd_reference(qkv, out, dout, lse, *ctx.args)
        else:
            # autograd may hand over a strided view (the caller transposes the output)
            dqkv = attention_qkv_bwd(qkv.contiguous(), out, dout.contiguous(), lse, *ctx.args)
        return dqkv, None, None, None, None


def attention_qkv_train(qkv: torch.Tensor, t: int | None, rate: float, seed: int,
                        site: int) -> torch.Tensor:
    """Differentiable training attention (dropout ``rate`` at ``(seed, site)``) -> ``[B, H, T, d]``."""
    return _AttentionQKV.apply(qkv, qkv.shape[2] if t is None else t, rate, seed, site)
