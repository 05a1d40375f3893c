"""Classification loss (port of ``train/losses.py::cross_entropy``).

The contrastive-focal and center losses of the vest runner come with the vest slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the rows with ``valid`` set (all rows without it);
    the weight sum is clamped at 1, as the JAX package's."""
    per = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if valid is None:
        return per.mean()
    w = valid.to(per.dtype)
    return (per * w).sum() / w.sum().clamp_min(1.0)
