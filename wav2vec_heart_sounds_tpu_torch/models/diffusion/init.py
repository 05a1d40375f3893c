"""The flax initialisers the vocoders use, drawn from a ``torch.Generator`` in place.

Each layer of :mod:`.diffwave` and :mod:`.wavegrad` is tagged with the flax initialiser of
its JAX counterpart (``layer.init_kind``); :func:`init_parameters` draws every tagged
layer's weight from one CPU generator (so every device gets the same weights) and zeroes its
bias. Fans follow flax's ``variance_scaling`` on the flax kernel layout (a conv's receptive
field times its channels).
"""

from __future__ import annotations

import math

import torch
from torch import nn

HE_NORMAL, LECUN_NORMAL, XAVIER_UNIFORM, ORTHOGONAL, ZEROS, EMBED = (
    "he_normal", "lecun_normal", "xavier_uniform", "orthogonal", "zeros", "embed")
_TRUNC_STD = 0.87962566103423978         # the std of a unit normal truncated at +-2


def tagged(layer: nn.Module, kind: str) -> nn.Module:
    layer.init_kind = kind
    return layer


def _fans(weight: torch.Tensor, transposed: bool) -> tuple[int, int]:
    """(fan_in, fan_out) of a torch weight: ``[out, in, *k]`` (``[in, out, *k]`` for a
    transposed conv); a 2-D embedding table gives its row count both ways, as flax's
    ``variance_scaling(out_axis=0)`` does."""
    field = math.prod(weight.shape[2:])
    cin, cout = weight.shape[1], weight.shape[0]
    if transposed:
        cin, cout = cout, cin
    return cin * field, cout * field


def _orthogonal(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()`` on the flax conv kernel ``[k, in, out]`` (columns = out)."""
    out_ch, in_ch, k = weight.shape
    rows, cols = k * in_ch, out_ch
    shape = (cols, rows) if rows < cols else (rows, cols)
    q, r = torch.linalg.qr(torch.randn(shape, generator=generator))
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return q.reshape(k, in_ch, out_ch).permute(2, 1, 0)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    for layer in model.modules():
        kind = getattr(layer, "init_kind", None)
        if kind is None:
            continue
        w = layer.weight
        if kind == EMBED:
            v = torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[0])
        elif kind == ZEROS:
            v = torch.zeros(w.shape)
        elif kind == ORTHOGONAL:
            v = _orthogonal(w, generator)
        else:
            fan_in, fan_out = _fans(w, isinstance(layer, nn.ConvTranspose2d))
            if kind == XAVIER_UNIFORM:
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                v = (2.0 * torch.rand(w.shape, generator=generator) - 1.0) * limit
            else:
                scale = 2.0 if kind == HE_NORMAL else 1.0
                std = math.sqrt(scale / fan_in) / _TRUNC_STD
                v = torch.empty(w.shape)
                nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        w.copy_(v)
        if getattr(layer, "bias", None) is not None:
            layer.bias.zero_()

