"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit), the
denominators of every ``*_mfu`` and ``*_roofline`` metric."""

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(bytes_moved: float, flops: float, dtype: torch.dtype = torch.bfloat16) -> float:
    """The least time the card could take: bytes over the memory rate or operations over the
    peak rate of ``dtype``'s products, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
