"""Robust loss weights for iteratively-reweighted least squares.

Port of ``tpu_slam.registration.robust``.
"""

from __future__ import annotations

import torch


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss: 1 inside delta, delta/|r| outside."""
    a = r.abs()
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


def tukey_weight(r: torch.Tensor, c: float) -> torch.Tensor:
    """IRLS weight of the Tukey biweight: (1 - (r/c)^2)^2 inside c, 0 outside."""
    u = r / c
    w = torch.square(1.0 - torch.square(u))
    return torch.where(u.abs() < 1.0, w, 0.0)


def cauchy_weight(r: torch.Tensor, c: float) -> torch.Tensor:
    return 1.0 / (1.0 + torch.square(r / c))
