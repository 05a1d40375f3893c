"""Time-varying sinc delay-and-sum beamformer (port of ``models/beamformer.py``).

A small post-norm transformer (:class:`DelayPredictor`) predicts a per-sample fractional
delay for every microphone, clipped to ``[0, max_delay_s * fs]``; each channel is delayed
by a 41-tap Hamming-windowed sinc (K7, :mod:`..ops.kernels.sinc_delay`), squared, and the
squares are summed over the microphones.

The predictor attends over every waveform sample through K6
(:mod:`..ops.kernels.flash_kv`). It runs in the compute dtype, so its delays come out in
it (rounded to bfloat16 in bfloat16, as the JAX package's); the delay and the sum of
squares are float32. All microphones of a batch go through one K7 launch per direction.

Parameter names follow the flax tree (``input_proj``, ``attn_{i}/{query,key,value,out}``,
``norm{1,2}_{i}``, ``ff{1,2}_{i}``, ``output_proj``), with the attention projections as
``[32, 32]`` linears (the flax ``[32, 4, 8]`` kernels reshaped, :mod:`.from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.kernels.flash_kv import flash_attention_kv
from ..ops.kernels.sinc_delay import delay_channel
from .wav2vec2 import LayerNorm

LN_EPS = 1e-5       # FastLayerNorm's default


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask or dropout) with K6."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(dim, dim, dtype=dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, T, D = h.shape
        heads = lambda t: t.view(B, T, self.num_heads, D // self.num_heads)  # noqa: E731
        out = flash_attention_kv(heads(self.query(h)), heads(self.key(h)), heads(self.value(h)))
        return self.out(out.reshape(B, T, D))


class DelayPredictor(nn.Module):
    """``[B, M, T]`` -> per-sample per-microphone delays ``[B, M, T]`` in the compute dtype."""

    def __init__(self, num_mics: int, d_model: int = 32, num_heads: int = 4, ffn: int = 64,
                 num_layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.num_layers = dtype, num_layers
        self.input_proj = nn.Linear(num_mics, d_model, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"attn_{i}", MultiHeadAttention(d_model, num_heads, dtype))
            self.add_module(f"norm1_{i}", LayerNorm(d_model, LN_EPS, dtype))
            self.add_module(f"ff1_{i}", nn.Linear(d_model, ffn, dtype=dtype))
            self.add_module(f"ff2_{i}", nn.Linear(ffn, d_model, dtype=dtype))
            self.add_module(f"norm2_{i}", LayerNorm(d_model, LN_EPS, dtype))
        self.output_proj = nn.Linear(d_model, num_mics, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.input_proj(x.transpose(1, 2).to(self.dtype))                  # [B, T, d]
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            h = layer("norm1")(h + layer("attn")(h))
            f = layer("ff2")(torch.relu(layer("ff1")(h)))
            h = layer("norm2")(h + f)
        return self.output_proj(h).transpose(1, 2)                             # [B, M, T]


class TimeVaryingSincBeamformer(nn.Module):
    """``[B, M, T]`` -> ``[B, T]`` float32: the sum over microphones of the squared,
    fractionally delayed channels."""

    def __init__(self, num_mics: int, fs: float, max_delay_s: float = 0.01,
                 kernel_size: int = 41, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_mics, self.kernel_size = num_mics, kernel_size
        self.max_delay = max_delay_s * fs
        self.window = tuple(float(w) for w in np.hamming(kernel_size).astype(np.float32))
        self.delay_predictor = DelayPredictor(num_mics, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, M, T = x.shape
        delays = self.delay_predictor(x).clamp(0.0, self.max_delay)
        y = delay_channel(x.reshape(B * M, T), delays.reshape(B * M, T), self.kernel_size,
                          self.window).view(B, M, T)
        total = torch.zeros((B, T), dtype=torch.float32, device=x.device)
        for m in range(M):                      # the JAX package's order of the sum
            total = total + y[:, m] ** 2
        return total
