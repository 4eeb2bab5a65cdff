"""Fixed-capacity padded point clouds.

Frozen copy of ``tpu_slam_torch.core.pointcloud``: a cloud is an (N, 3)
float32 tensor plus an (N,) bool mask; padding rows sit at PAD_COORD so
distance logic rejects them."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PAD_COORD = 1.0e8


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud: points (N, 3), mask (N,) bool, attrs (N, A)."""

    points: torch.Tensor
    mask: torch.Tensor
    attrs: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def transform(self, T: torch.Tensor) -> "PointCloud":
        from slambench.reference import se3
        pts = se3.apply(T, self.points)
        pts = torch.where(self.mask[:, None], pts, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def sanitize(self) -> "PointCloud":
        """Force invalid rows onto the sentinel (idempotent)."""
        pts = torch.where(self.mask[..., None], self.points, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def compact(self) -> "PointCloud":
        """Stable-sort valid points to the front (same capacity)."""
        order = torch.argsort((~self.mask).to(torch.int32), stable=True)
        attrs = None if self.attrs is None else self.attrs[order]
        return PointCloud(points=self.points[order], mask=self.mask[order],
                          attrs=attrs)


