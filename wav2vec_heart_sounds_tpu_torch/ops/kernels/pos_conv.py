"""The encoder's positional convolution with its erf GELU: the CUDA kernels, the plain
version, autograd.

``gelu(conv1d(x, w, b, padding=K // 2, groups))`` on the encoder's ``[B, T, D]`` layout,
the trailing frame dropped for an even ``K`` (wav2vec2's ``PositionalConvEmbedding``), with
``w`` and ``b`` ``nn.Conv1d``'s ``[D, D / groups, K]`` and ``[D]``. The JAX package leaves this
layer to XLA (``wav2vec_heart_sounds_tpu/models/wav2vec2.py:551-570``); the kernels replace
no TPU kernel. On the card cuDNN's default heuristics took a generic dgrad engine for the
bfloat16 backward at 48 channels a group (wav2vec2-base), at about 1000 times the layer's
bound.

:func:`pos_conv_gelu` is the op, one algorithm chosen by what its input is: bfloat16 CUDA
tensors take ``csrc/pos_conv.cu`` through :class:`_PosConvGelu` (the channels of a group,
16, 32, 48, 64 or 80, pick a template instance; any other width raises); float32 CUDA tensors
and CPU tensors take :func:`pos_conv_gelu_plain`, the ``nn.Conv1d`` formulation the model
has always had, with PyTorch's autograd. The kernels' contract: the products of bfloat16
summed in float32; ``pre`` (the conv plus bias) rounded to bfloat16 and kept for the
backward, the output the erf GELU of the float32 sum; the backward takes the GELU's gradient
at the rounded ``pre``, rounds ``dpre`` to bfloat16, and returns ``dx``, ``dW`` and ``db``
from float32 sums, ``dW`` and ``db`` through partials over fixed row ranges reduced in a
fixed order (the same bits run to run). :func:`relay_weight` lays the weight out as the
kernels read it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.observe import count
from . import build
from .dropout import check_cuda, sm_count

_P, _I = ctypes.c_void_p, ctypes.c_int
# Channels a group (the test config, a 512-wide encoder in 16 groups, base, large, XLS-R 1B):
# a template instance each.
WIDTHS = (16, 32, 48, 64, 80)
ROW_PAD = 8                 # the re-laid weight's rows: C + 8 bfloat16, as in shared memory
MAX_WIDTH = 2048            # D: the dpre pass takes a row in 16-byte runs of one block
DW_FRAMES, DW_TAPS = 64, 8  # a dW block: 64-frame row tiles, 8 taps (csrc/pos_conv.cu)


def kernel_takes(d: int, groups: int) -> bool:
    """Whether the kernels take ``d`` channels in ``groups`` groups: a width a group in
    :data:`WIDTHS` and at most :data:`MAX_WIDTH` channels."""
    return d % groups == 0 and d // groups in WIDTHS and d <= MAX_WIDTH


def check_widths(name: str, d: int, groups: int) -> int:
    """The channels a group, or ``ValueError`` for a width the kernels do not take."""
    if not kernel_takes(d, groups):
        raise ValueError(f"{name}: the kernels take {list(WIDTHS)} channels a group and at "
                         f"most {MAX_WIDTH} channels, got {d} channels in {groups} groups")
    return d // groups


def takes_kernel(x: torch.Tensor) -> bool:
    """The op's route: the kernels for a bfloat16 CUDA tensor, the plain version else."""
    return x.is_cuda and x.dtype == torch.bfloat16


# ---- the plain version ----------------------------------------------------------------------

def pos_conv_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                        groups: int) -> torch.Tensor:
    """``nn.Conv1d`` on the transposed view, the trailing frame dropped for an even kernel,
    the exact erf GELU: the CPU and float32 route, differentiable by PyTorch's autograd."""
    k = w.shape[-1]
    h = F.conv1d(x.transpose(1, 2), w, b, padding=k // 2, groups=groups)
    if k % 2 == 0:
        h = h[:, :, :-1]
    return F.gelu(h, approximate="none").transpose(1, 2)


# ---- the kernels ----------------------------------------------------------------------------

def relay_weight(w: torch.Tensor, groups: int, flip: bool = False) -> torch.Tensor:
    """``w [D, C, K]`` re-laid as the kernels read it, ``[G, K, C, C + 8]`` (a copy, the last 8
    columns zero): ``wr[g, j, o, c] = w[gC + o, c, j]`` for the forward; with ``flip`` (dx)
    the taps flipped and each tap transposed, ``wr[g, j, c, o] = w[gC + o, c, K - 1 - j]``."""
    d, c, k = w.shape
    wg = w.view(groups, c, c, k)
    out = w.new_zeros((groups, k, c, c + ROW_PAD))
    out[..., :c] = wg.permute(0, 3, 2, 1).flip(1) if flip else wg.permute(0, 3, 1, 2)
    return out


def _check(name: str, x: torch.Tensor, w: torch.Tensor, groups: int) -> tuple[int, int, int, int]:
    check_cuda(name, x, w)
    if x.ndim != 3 or w.ndim != 3 or w.shape[0] != x.shape[2] or \
            w.shape[0] != w.shape[1] * groups:
        raise ValueError(f"{name}: expected x [B, T, D] and w [D, D / groups, K], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)} in {groups} groups")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernels take bfloat16, got {x.dtype} and {w.dtype}")
    B, t, d = x.shape
    return B, t, d, check_widths(name, d, groups)


def dpre_parts(rows: int, device: torch.device) -> int:
    """Blocks of the dpre pass, each a range of rows and a row of db's column partials: two
    an SM, at least 16 rows each."""
    return max(1, min(2 * sm_count(device), -(-rows // 16)))


def dw_parts(B: int, t: int, k: int, groups: int, device: torch.device) -> int:
    """Row ranges of the dW partials: enough (part, group, 8-tap) blocks for four waves of
    two blocks an SM, at most one a 64-frame tile."""
    blocks = groups * -(-k // DW_TAPS)
    tiles = B * -(-t // DW_FRAMES)
    return max(1, min(tiles, -(-8 * sm_count(device) // blocks)))


def _ptr(a: torch.Tensor | None):
    return a.data_ptr() if a is not None else None


def pos_conv_fwd_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                        groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward of ``csrc/pos_conv.cu``; counts calls in ``.launches``. Returns
    ``(out, pre)``, each ``[B, T, D]`` bfloat16."""
    name = "pos_conv_fwd_kernel"
    B, t, d, c = _check(name, x, w, groups)
    if b is not None:
        check_cuda(name, b)
        if b.shape != (d,) or b.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected a bfloat16 bias [{d}], got {b.dtype} "
                             f"{tuple(b.shape)}")
    out, pre = torch.empty_like(x), torch.empty_like(x)
    wr = relay_weight(w, groups)
    fn = build.entry("pos_conv", "pos_conv_fwd_bf16", (_P,) * 5 + (_I,) * 5 + (_P,))
    build.check(fn(x.data_ptr(), wr.data_ptr(), _ptr(b), out.data_ptr(), pre.data_ptr(), B, t, d,
                   c, w.shape[2], build.stream(x)), name)
    pos_conv_fwd_kernel.launches += 1
    count("posconv.launches")
    return out, pre


def pos_conv_bwd_kernel(x: torch.Tensor, w: torch.Tensor, pre: torch.Tensor, g: torch.Tensor,
                        groups: int, need_dx: bool = True, need_dw: bool = True,
                        need_db: bool = True):
    """Launch the backward of ``csrc/pos_conv.cu`` (dpre and db's column partials, then dx,
    the dW partials and the reduce pass, each where needed); counts calls in ``.launches``.
    Returns ``(dx, dw, db)`` (``None`` where not needed)."""
    name = "pos_conv_bwd_kernel"
    B, t, d, c = _check(name, x, w, groups)
    check_cuda(name, pre, g)
    if pre.shape != x.shape or g.shape != x.shape or {pre.dtype, g.dtype} != {torch.bfloat16}:
        raise ValueError(f"{name}: pre and g must be bfloat16 {list(x.shape)}")
    k = w.shape[2]
    device = x.device
    n_db, n_parts = dpre_parts(B * t, device), dw_parts(B, t, k, groups, device)
    dpre = torch.empty_like(x)
    dbp = torch.empty((n_db, d), dtype=torch.float32, device=device) if need_db else None
    dx = torch.empty_like(x) if need_dx else None
    wd = relay_weight(w, groups, flip=True) if need_dx else None
    parts = (torch.empty((n_parts, groups, k, c, c), dtype=torch.float32, device=device)
             if need_dw else None)
    dw = torch.empty_like(w) if need_dw else None
    db = torch.empty(d, dtype=w.dtype, device=device) if need_db else None
    fn = build.entry("pos_conv", "pos_conv_bwd_bf16", (_P,) * 10 + (_I,) * 10 + (_P,))
    build.check(fn(x.data_ptr(), g.data_ptr(), pre.data_ptr(), _ptr(wd), dpre.data_ptr(),
                   _ptr(dbp), _ptr(dx), _ptr(parts), _ptr(dw), _ptr(db), B, t, d, c, k, n_db,
                   n_parts, int(need_dx), int(need_dw), int(need_db), build.stream(x)), name)
    pos_conv_bwd_kernel.launches += 1
    count("posconv.launches")
    return dx, dw, db


pos_conv_fwd_kernel.launches = 0
pos_conv_bwd_kernel.launches = 0


class _PosConvGelu(torch.autograd.Function):
    """The kernels' op: forward and backward each one wrapper call (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, w, b, groups):
        ctx.groups = groups
        x, w = x.contiguous(), w.contiguous()
        out, pre = pos_conv_fwd_kernel(x, w, None if b is None else b.contiguous(), groups)
        ctx.save_for_backward(x, w, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, pre = ctx.saved_tensors
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        dx, dw, db = pos_conv_bwd_kernel(x, w, pre, g.contiguous(), ctx.groups, need_dx,
                                         need_dw, need_db)
        return (dx if need_dx else None, dw if need_dw else None, db if need_db else None,
                None)


def pos_conv_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  groups: int) -> torch.Tensor:
    """``gelu(conv1d(x^T, w, b, padding=K // 2, groups))^T`` for ``x [B, T, D]`` -> ``[B, T,
    D]`` (an even kernel's trailing frame dropped), exact erf GELU; differentiable. The
    kernels for bfloat16 CUDA tensors, the plain version for the rest."""
    if takes_kernel(x):
        return _PosConvGelu.apply(x, w, b, groups)
    return pos_conv_gelu_plain(x, w, b, groups)
