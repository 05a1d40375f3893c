"""Packed-QKV attention forward: the hand-written CUDA kernel and its plain version.

Port of ``wav2vec_heart_sounds_tpu/ops/pallas/attention.py::flash_attention_qkv`` at
dropout rate 0 (eval). Layouts are the JAX package's: input ``[B, 3H, T, d]`` with heads
``0..H-1`` = Q, ``H..2H-1`` = K, ``2H..3H-1`` = V; output ``[B, H, T, d]``. Keys at
positions ``>= t`` are masked. Scores and softmax are float32; the output has the input
dtype.

:func:`flash_attention_qkv` takes the plain version only for CPU tensors; a CUDA tensor
goes to the kernel (``csrc/attention_qkv_fwd.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64   # wav2vec2-base: 768 hidden / 12 heads; the only width the kernel is built for


def attention_qkv_reference(qkv: torch.Tensor, t: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: f32 einsum, key mask, softmax, PV; output in the input dtype."""
    B, H3, T, d = qkv.shape
    H = H3 // 3
    t = T if t is None else t
    q, k, v = (qkv[:, i * H:(i + 1) * H].float() for i in range(3))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(d))
    if t < T:
        mask = torch.arange(T, device=qkv.device) >= t
        scores = scores.masked_fill(mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).to(qkv.dtype)


def _check(qkv: torch.Tensor, t: int) -> None:
    if not qkv.is_cuda:
        raise ValueError(f"attention_qkv_fwd needs a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_qkv_fwd takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.ndim != 4 or qkv.shape[1] % 3:
        raise ValueError(f"expected packed [B, 3H, T, d], got {tuple(qkv.shape)}")
    if qkv.shape[3] != HEAD_DIM:
        raise ValueError(f"head dim {qkv.shape[3]}: the kernel is built for {HEAD_DIM}")
    if not qkv.is_contiguous():
        raise ValueError("attention_qkv_fwd needs a contiguous [B, 3H, T, d] tensor")
    if not 1 <= t <= qkv.shape[2]:
        raise ValueError(f"key count t={t} outside [1, T={qkv.shape[2]}]")


@functools.cache
def _entry():
    """The C entry point of ``csrc/attention_qkv_fwd.cu`` (built at first use), typed."""
    fn = load_library("attention_qkv_fwd").attention_qkv_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_qkv_fwd(qkv: torch.Tensor, t: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; counts launches in ``.launches``."""
    B, H3, T, d = qkv.shape
    t = T if t is None else int(t)
    _check(qkv, t)
    fn = _entry()
    out = torch.empty((B, H3 // 3, T, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), B, H3 // 3, T, d, t,
                 1.0 / math.sqrt(d), _DTYPE_CODES[qkv.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv_fwd launch failed: cudaError {err}")
    attention_qkv_fwd.launches += 1
    return out


attention_qkv_fwd.launches = 0


def flash_attention_qkv(qkv: torch.Tensor, t: int | None = None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Attention over a packed ``[B, 3H, T, d]`` tensor -> ``[B, H, T, d]``.

    CPU tensors take :func:`attention_qkv_reference`; CUDA tensors the kernel.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) comes with the training port: Philox dropout in "
            "the kernel and its backward; the port runs eval mode only")
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, t)
    return attention_qkv_fwd(qkv, t)
