"""Long-sequence attention with a small head dim (K6): CUDA kernels, plain versions, autograd.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/flash_kv.py::flash_attention_kv``, the
delay predictor's attention over every waveform sample. Inputs are ``[B, T, H, d]`` (the
flax ``attention_fn`` layout), the softmax is exact and unmasked, the scores are scaled by
``1 / sqrt(d)`` inside. Everything inside is float32: a bfloat16 input is cast at the
boundary and the output cast back (``flash_kv.py:322-331``). The forward saves the row
log-sum-exp (float32 ``[B, H, T]``); the backward is the fused one-pass form of the JAX
package's default ``_bwd_fused_kernel``: ``delta = rowsum(g * o)``, then one pass per block
of :data:`KEY_BLOCK` keys that recomputes the probabilities from the lse and gives that
block's dk, dv and a dq partial, then the partials summed in key-block order. One wrapper
call, three kernels (delta, the pass, the dq reduce).

The plain versions are the query-chunked exact softmax of the JAX package's
``_chunked_attention`` (``models/beamformer.py:54-71``), chunks of 512 query rows so that
no ``[B, H, T, T]`` tensor exists, and the kernel's key-blocked form for the backward.
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
KEY_BLOCK = 512     # keys per block of the backward (csrc/flash_kv.cu kKeyBlock)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _heads(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3)                 # [B, T, H, d] -> [B, H, T, d] (a view)


def _chunks(T: int, size: int = CHUNK):
    return [(i, min(T, i + size)) for i in range(0, T, size)]


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


def attention_kv_bwd_reference(q, k, v, o, lse, g,
                               key_block: int = KEY_BLOCK) -> tuple[torch.Tensor, ...]:
    """Plain fused backward, the kernel's form: ``(dq, dk, dv)``. ``delta = rowsum(g * o)``;
    per block of ``key_block`` keys one pass over the query chunks recomputes the
    probabilities from the lse once and gives the block's dk, dv and a dq partial; the
    partials are summed in key-block order, then scaled."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh, gh = _heads(q), _heads(k), _heads(v), _heads(g)
    delta = (gh * _heads(o)).sum(dim=-1)
    dq, dks, dvs = None, [], []
    for j0, j1 in _chunks(q.shape[1], key_block):
        kc, vc = kh[:, :, j0:j1], vh[:, :, j0:j1]
        dk, dv, part = torch.zeros_like(kc), torch.zeros_like(vc), []
        for i0, i1 in _chunks(q.shape[1]):
            qc, gc = qh[:, :, i0:i1], gh[:, :, i0:i1]
            p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale - lse[:, :, i0:i1, None])
            dv += torch.einsum("bhqk,bhqd->bhkd", p, gc)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", gc, vc) - delta[:, :, i0:i1, None])
            dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc)
            part.append(torch.einsum("bhqk,bhkd->bhqd", ds, kc))
        part = torch.cat(part, dim=2)
        dq = part if dq is None else dq + part
        dks.append(dk * scale)
        dvs.append(dv)
    return (_heads(dq * scale).contiguous(), _heads(torch.cat(dks, dim=2)).contiguous(),
            _heads(torch.cat(dvs, dim=2)).contiguous())


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
    """Launch the fused backward of ``csrc/flash_kv.cu``: the delta pre-pass, one pass per
    block of keys writing dk, dv and a dq partial, and the dq reduce; counts calls in
    ``.launches`` (three kernels each)."""
    B, T, H = _check("flash_kv_bwd_kernel", q, k, v, o, g)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, T) or not lse.is_contiguous():
        raise ValueError("flash_kv_bwd_kernel: lse must be contiguous float32 [B, H, T]")
    key_block = build.entry("flash_kv", "flash_kv_key_block", ())()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    dq_part = torch.empty((-(-T // key_block), B, H, T, HEAD_DIM), dtype=torch.float32,
                          device=q.device)
    fn = build.entry("flash_kv", "flash_kv_bwd", (_P,) * 11 + (_I,) * 4 + (_F, _P))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                   g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                   dq_part.data_ptr(), B, T, H, HEAD_DIM, 1.0 / math.sqrt(HEAD_DIM),
                   build.stream(q)), "flash_kv_bwd_kernel")
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
