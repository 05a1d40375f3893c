"""Long-sequence attention with a small head dim (K6): CUDA kernels, plain versions, autograd.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/flash_kv.py::flash_attention_kv``, the
delay predictor's attention over every waveform sample. Inputs are ``[B, T, H, d]`` (the
flax ``attention_fn`` layout), the softmax is exact and unmasked, the scores are scaled by
``1 / sqrt(d)`` inside. Everything inside is float32: a bfloat16 input is cast at the
boundary and the output cast back (``flash_kv.py:322-331``). The forward saves the row
log-sum-exp (float32 ``[B, H, T]``); the backward is the split form, a dq pass (which also
writes ``delta = rowsum(g * o)``) and a dk/dv pass, each recomputing the probabilities
from the lse: one wrapper call, two kernels.

The plain versions are the query-chunked exact softmax of the JAX package's
``_chunked_attention`` (``models/beamformer.py:54-71``), chunks of 512 query rows so that
no ``[B, H, T, T]`` tensor exists, and the same chunking for the backward formulas.
:func:`flash_attention_kv` takes them only for CPU tensors; CUDA tensors go to
``csrc/flash_kv.cu`` or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIM = 8        # the delay predictor's head width (d_model 32 / 4 heads)
CHUNK = 512         # query rows per chunk of the plain versions
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _heads(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)                 # [B, T, H, d] -> [B, H, T, d] (a view)


def _chunks(T: int):
    return [(i, min(T, i + CHUNK)) for i in range(0, T, CHUNK)]


def attention_kv_fwd_reference(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward, float32 ``[B, T, H, d]``: ``(o, lse)`` with lse ``[B, H, T]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    outs, lses = [], []
    for i0, i1 in _chunks(q.shape[1]):
        s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, i0:i1], kh) * scale
        lse = torch.logsumexp(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), vh))
        lses.append(lse)
    return _heads(torch.cat(outs, dim=2)).contiguous(), torch.cat(lses, dim=2)


def attention_kv_bwd_reference(q, k, v, o, lse, g) -> tuple[torch.Tensor, ...]:
    """Plain split backward: ``(dq, dk, dv)``. The dq pass (which also forms
    ``delta = rowsum(g * o)``), then the dk/dv pass summing over query chunks; each
    recomputes the probabilities from the lse."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh, gh = _heads(q), _heads(k), _heads(v), _heads(g)
    delta = (gh * _heads(o)).sum(dim=-1)
    dqs = []
    for i0, i1 in _chunks(q.shape[1]):
        s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, i0:i1], kh) * scale
        p = torch.exp(s - lse[:, :, i0:i1, None])
        dp = torch.einsum("bhqd,bhkd->bhqk", gh[:, :, i0:i1], vh)
        ds = p * (dp - delta[:, :, i0:i1, None])
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for i0, i1 in _chunks(q.shape[1]):
        qc, gc = qh[:, :, i0:i1], gh[:, :, i0:i1]
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kh) * scale
        p = torch.exp(s - lse[:, :, i0:i1, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, gc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", gc, vh) - delta[:, :, i0:i1, None])
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
    return (_heads(torch.cat(dqs, dim=2)).contiguous(), _heads(dk).contiguous(),
            _heads(dv).contiguous())


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int, int]:
    B, T, H, d = tensors[0].shape
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 (bfloat16 is cast at the boundary), "
                            f"got {t.dtype}")
        if tuple(t.shape) != (B, T, H, d) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned [B, T, H, d] tensors "
                             f"of one shape")
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernels are built for {HEAD_DIM}")
    return B, T, H


def flash_kv_fwd_kernel(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``csrc/flash_kv.cu``; counts launches in ``.launches``."""
    B, T, H = _check("flash_kv_fwd_kernel", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_kv", "flash_kv_fwd", (_P,) * 5 + (_I,) * 4 + (_F, _P))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B,
                   T, H, HEAD_DIM, 1.0 / math.sqrt(HEAD_DIM), build.stream(q)),
                "flash_kv_fwd_kernel")
    flash_kv_fwd_kernel.launches += 1
    return o, lse


def flash_kv_bwd_kernel(q, k, v, o, lse, g) -> tuple[torch.Tensor, ...]:
    """Launch the backward of ``csrc/flash_kv.cu``: the dq kernel (which writes delta),
    then the dk/dv kernel; counts calls in ``.launches`` (two kernels each)."""
    B, T, H = _check("flash_kv_bwd_kernel", q, k, v, o, g)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) or not lse.is_contiguous():
        raise ValueError("flash_kv_bwd_kernel: lse must be contiguous float32 [B, H, T]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    scale, stream = 1.0 / math.sqrt(HEAD_DIM), build.stream(q)
    args = (_P,) * 8 + (_I,) * 4 + (_F, _P)
    dq_fn = build.entry("flash_kv", "flash_kv_dq", args)
    build.check(dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                      g.data_ptr(), dq.data_ptr(), delta.data_ptr(), B, T, H, HEAD_DIM, scale,
                      stream), "flash_kv_bwd_kernel (dq)")
    dkv_fn = build.entry("flash_kv", "flash_kv_dkv", args)
    build.check(dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, HEAD_DIM,
                       scale, stream), "flash_kv_bwd_kernel (dk/dv)")
    flash_kv_bwd_kernel.launches += 1
    return dq, dk, dv


flash_kv_fwd_kernel.launches = 0
flash_kv_bwd_kernel.launches = 0


class _FlashKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = attention_kv_fwd_reference(q, k, v)
        else:
            o, lse = flash_kv_fwd_kernel(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            return attention_kv_bwd_reference(q, k, v, o, lse, g)
        return flash_kv_bwd_kernel(q, k, v, o, lse, g)


def flash_attention_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None,
                       bias=None, dropout_rate: float = 0.0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over ``[B, T, H, d]``, float32 inside, output in the
    input dtype; differentiable. Raises on a mask, a bias or dropout, which it has not
    (``models/beamformer.py:41-44``)."""
    if mask is not None or bias is not None or dropout_rate:
        raise NotImplementedError(
            "DelayPredictor attention has no mask/bias/dropout support; got "
            f"mask={mask is not None}, bias={bias is not None}, rate={dropout_rate}")
    dt = q.dtype
    f32 = [t.float().contiguous() for t in (q, k, v)]
    return _FlashKV.apply(*f32).to(dt)
