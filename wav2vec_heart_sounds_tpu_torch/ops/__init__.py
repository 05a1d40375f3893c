"""Batched device primitives of the preprocessing chain, and the hand-written kernels."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32 (no TF32) inside the block.

    cuDNN runs float32 convolutions in TF32 by default, which keeps only ~3 decimal
    digits; the preprocessing chain is held to the float64 oracle at max-abs < 5e-3 and to
    the JAX package at 1e-4, so its convolutions and matmuls opt out. Restores the
    caller's settings on exit.
    """
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
