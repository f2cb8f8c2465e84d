"""Training losses (torch), as ``ngpd_tpu/learn/losses.py``.

The sign-invariant "custom" losses reflect that a patch normal is only
defined up to orientation:
  custom_val_loss  = mean(min((x+y)^2, (x-y)^2))
  custom_cos_loss  = mean(min(1-cos, 1+cos))
``cos_loss`` is the raw mean cosine similarity (higher is better), the
value the reference logs; the cosine's denominator is clamped at 1e-8.
"""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def cosine_similarity(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    num = torch.sum(pred * target, dim=-1)
    den = torch.clamp(torch.linalg.norm(pred, dim=-1) * torch.linalg.norm(target, dim=-1),
                      min=1e-8)
    return num / den


def cos_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(cosine_similarity(pred, target))


def custom_val_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    loss1 = torch.mean((pred + target) ** 2, dim=-1)
    loss2 = torch.mean((pred - target) ** 2, dim=-1)
    return torch.mean(torch.minimum(loss1, loss2))


def custom_cos_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    sim = cosine_similarity(pred, target)
    return torch.mean(torch.minimum(1.0 - sim, 1.0 + sim))


def all_losses(pred: torch.Tensor, target: torch.Tensor) -> dict[str, torch.Tensor]:
    """The four metrics logged per split."""
    return {
        "val_loss": mse_loss(pred, target),
        "cos_loss": cos_loss(pred, target),
        "custom_val_loss": custom_val_loss(pred, target),
        "custom_cos_loss": custom_cos_loss(pred, target),
    }
