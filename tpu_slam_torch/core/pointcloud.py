"""Fixed-capacity padded point clouds.

Port of ``tpu_slam.core.pointcloud``: a cloud is an (N, 3) float32 tensor
plus an (N,) bool mask; padding rows sit at PAD_COORD so distance logic
rejects them. Fixed capacities keep every shape static, which makes the
per-scan step allocation-stable and the CPU tests comparable to the JAX
reference row for row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    @staticmethod
    def from_points_host(points, capacity: int, attrs=None,
                         device=None) -> "PointCloud":
        """Build from a host (numpy) (M, 3) array, padding on the host."""
        from tpu_slam_torch import default_device

        dev = default_device(device)
        pts = np.asarray(points, np.float32)
        m = pts.shape[0]
        if m > capacity:
            raise ValueError(f"{m} points exceed capacity {capacity}")
        out = np.full((capacity, 3), PAD_COORD, np.float32)
        out[:m] = pts
        mask = np.zeros((capacity,), bool)
        mask[:m] = True
        a = None
        if attrs is not None:
            attrs = np.asarray(attrs)
            a = np.zeros((capacity, attrs.shape[1]), attrs.dtype)
            a[:m] = attrs
            a = torch.from_numpy(a).to(dev)
        return PointCloud(points=torch.from_numpy(out).to(dev),
                          mask=torch.from_numpy(mask).to(dev), attrs=a)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        from tpu_slam_torch.core import se3
        pts = se3.apply(T, self.points)
        pts = torch.where(self.mask[:, None], pts, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def sanitize(self) -> "PointCloud":
        """Force invalid rows onto the sentinel (idempotent)."""
        pts = torch.where(self.mask[..., None], self.points, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def filter(self, keep: torch.Tensor) -> "PointCloud":
        """AND the mask with ``keep`` and re-sanitize (same capacity)."""
        mask = self.mask & keep
        pts = torch.where(mask[:, None], self.points, PAD_COORD)
        return dataclasses.replace(self, points=pts, mask=mask)

    def compact(self) -> "PointCloud":
        """Stable-sort valid points to the front (same capacity)."""
        order = torch.argsort((~self.mask).to(torch.int32), stable=True)
        attrs = None if self.attrs is None else self.attrs[order]
        return PointCloud(points=self.points[order], mask=self.mask[order],
                          attrs=attrs)


def exclusion_box_filter(cloud: PointCloud, box_min, box_max) -> PointCloud:
    """Robot self-filter: KEEP the points OUTSIDE the axis-aligned box
    (the aggregator's inverted bounding box: points inside the box around
    the robot are dropped)."""
    lo = torch.as_tensor(box_min, dtype=cloud.points.dtype,
                         device=cloud.device)
    hi = torch.as_tensor(box_max, dtype=cloud.points.dtype,
                         device=cloud.device)
    inside = ((cloud.points >= lo) & (cloud.points <= hi)).all(dim=-1)
    return cloud.filter(~inside)


def range_filter(cloud: PointCloud, min_range: float, max_range: float,
                 origin=None) -> PointCloud:
    """Keep the points whose range from ``origin`` lies in [min_range,
    max_range]."""
    pts = cloud.points
    if origin is not None:
        pts = pts - torch.as_tensor(origin, dtype=pts.dtype,
                                    device=cloud.device)
    r2 = (pts * pts).sum(dim=-1)
    keep = (r2 >= min_range * min_range) & (r2 <= max_range * max_range)
    return cloud.filter(keep)


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two padded clouds (capacity = sum of capacities); the
    attributes only when both have them."""
    attrs = None
    if a.attrs is not None and b.attrs is not None:
        attrs = torch.cat([a.attrs, b.attrs])
    return PointCloud(points=torch.cat([a.points, b.points]),
                      mask=torch.cat([a.mask, b.mask]), attrs=attrs)
