"""The vocoders' layers with a compute dtype apart from their parameters' (flax's ``dtype=``).

A flax layer built with ``dtype=jnp.bfloat16`` keeps its parameters in float32
(``param_dtype``) and casts its kernel, its bias and its input to bfloat16 where it computes.
These ``nn.Conv1d`` / ``nn.Linear`` / ``nn.ConvTranspose2d`` / ``nn.Embedding`` do the same
with ``compute_dtype`` (float32 unless :func:`set_compute_dtype` says otherwise), so the
optimizer updates float32 parameters and checkpoints hold float32 whatever the model computes
in. At float32 every cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class _ComputeDtype:
    compute_dtype = torch.float32

    def _cast(self, *tensors):
        return [None if t is None else t.to(self.compute_dtype) for t in tensors]


class Conv1d(_ComputeDtype, nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*self._cast(x, self.weight, self.bias))


class Linear(_ComputeDtype, nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*self._cast(x, self.weight, self.bias))


class ConvTranspose2d(_ComputeDtype, nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x, self.weight, self.bias)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Embedding(_ComputeDtype, nn.Embedding):
    def forward(self, index: torch.Tensor) -> torch.Tensor:
        return F.embedding(index, self.weight.to(self.compute_dtype), self.padding_idx,
                           self.max_norm, self.norm_type, self.scale_grad_by_freq, self.sparse)


def set_compute_dtype(model: nn.Module, dtype: torch.dtype, keep_float32=()) -> None:
    """Every layer of ``model`` computes in ``dtype`` but ``keep_float32``'s (the float32
    output layers, as the JAX modules build them with ``dtype=jnp.float32``)."""
    kept = {id(layer) for layer in keep_float32}
    for layer in model.modules():
        if isinstance(layer, _ComputeDtype) and id(layer) not in kept:
            layer.compute_dtype = dtype
