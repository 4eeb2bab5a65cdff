"""Robust loss weights for iteratively-reweighted least squares.

Frozen copy of ``tpu_slam_torch.registration.robust``.
"""

from __future__ import annotations

import torch


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber loss: 1 inside delta, delta/|r| outside."""
    a = r.abs()
    return torch.where(a <= delta, 1.0, delta / torch.clamp(a, min=1e-12))


