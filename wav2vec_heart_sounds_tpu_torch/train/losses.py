"""Classification losses (port of ``train/losses.py``): cross-entropy, supervised
contrastive, center and contrastive-focal.

The vest runner trains with ``beta * contrastive + alpha * CE + 0.01 * center`` (alpha 0.5,
beta 0.2, temperature 0.7); the center loss's class centres are trainable parameters of
the loss, which the trainer hands to its optimizer beside the model's.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def center_loss(centers: torch.Tensor, features: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each feature to its learnable class centre."""
    return ((features - centers[labels.long()]) ** 2).sum(dim=1).mean()


def supervised_contrastive(features: torch.Tensor, labels: torch.Tensor,
                           temperature: float = 0.7) -> torch.Tensor:
    """Pull same-class features together, push different-class ones apart (cosine
    similarity); rows without a positive are left out of the mean."""
    feats = features / features.norm(dim=1, keepdim=True).clamp_min(1e-12)
    sim = feats @ feats.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()

    n = labels.shape[0]
    same = labels[None, :] == labels[:, None]
    not_self = ~torch.eye(n, dtype=torch.bool, device=labels.device)
    positives = same & not_self

    exp_sim = torch.exp(sim) * not_self
    log_prob = sim - torch.log(exp_sim.sum(dim=1, keepdim=True) + 1e-8)
    pos_counts = positives.sum(dim=1)
    has_pos = pos_counts > 0
    mean_log_prob = (log_prob * positives).sum(dim=1) / pos_counts.clamp_min(1)
    total = torch.where(has_pos, -mean_log_prob, 0.0).sum()
    return total / has_pos.sum().clamp_min(1)


@dataclass(frozen=True)
class ContrastiveFocalConfig:
    num_classes: int = 2
    feature_dim: int = 768
    alpha: float = 0.5          # CE weight
    beta: float = 0.2           # contrastive weight
    center_weight: float = 0.01
    temperature: float = 0.7
    use_center: bool = True


def init_contrastive_focal(generator: torch.Generator, cfg: ContrastiveFocalConfig,
                           device="cpu") -> dict[str, torch.nn.Parameter]:
    """Loss-side trainable parameters: the class centres, standard normal (float32)."""
    if not cfg.use_center:
        return {}
    centers = torch.randn((cfg.num_classes, cfg.feature_dim), generator=generator)
    return {"centers": torch.nn.Parameter(centers.to(device))}


def contrastive_focal_loss(loss_params: dict, cfg: ContrastiveFocalConfig,
                           features: torch.Tensor, logits: torch.Tensor,
                           labels: torch.Tensor,
                           valid: torch.Tensor | None = None) -> torch.Tensor:
    total = (cfg.beta * supervised_contrastive(features, labels, cfg.temperature)
             + cfg.alpha * cross_entropy(logits, labels, valid))
    if cfg.use_center and "centers" in loss_params:
        total = total + cfg.center_weight * center_loss(loss_params["centers"],
                                                        features, labels)
    return total
