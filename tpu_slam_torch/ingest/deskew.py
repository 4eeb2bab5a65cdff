"""Motion compensation (deskew) for scans captured under motion.

Port of ``tpu_slam.ingest.deskew``. Each point carries its capture time
as a fraction of the sweep; the pose is interpolated on SE(3) between the
sweep-start and sweep-end poses (constant twist across the sweep,
T(a) = T0 exp(a log(T0^-1 T1))) and the point is carried into the
sweep-end frame. The reference's per-point ``vmap`` is one batched
``se3.exp`` over the point axis here.
"""

from __future__ import annotations

import math

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud


def interpolate_pose(T0: torch.Tensor, T1: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation on SE(3); ``alpha`` in [0, 1], any shape
    (the result has ``alpha``'s shape + (4, 4))."""
    xi = se3.log(se3.compose(se3.inverse(T0), T1))
    return se3.compose(T0, se3.exp(alpha[..., None] * xi))


def deskew_cloud(cloud: PointCloud, time_frac: torch.Tensor,
                 T_start: torch.Tensor, T_end: torch.Tensor) -> PointCloud:
    """Undistort a cloud into the sweep-END body frame.

    ``time_frac`` (N,) in [0, 1] is each point's capture time within the
    sweep (VLP-16: azimuth / 2 pi); ``T_start``/``T_end`` are world<-body
    poses at the sweep's start and end. Point i goes through
    T_end^-1 T_start exp(a_i xi); padded rows are left as they are.
    """
    xi = se3.log(se3.compose(se3.inverse(T_start), T_end))
    base = se3.compose(se3.inverse(T_end), T_start)
    M = se3.compose(base, se3.exp(time_frac[:, None] * xi))     # (N, 4, 4)
    pts = (M[:, :3, :3] @ cloud.points[:, :, None])[:, :, 0] + M[:, :3, 3]
    pts = torch.where(cloud.mask[:, None], pts, cloud.points)
    return PointCloud(points=pts, mask=cloud.mask, attrs=cloud.attrs)


def vlp16_time_fractions(points: torch.Tensor) -> torch.Tensor:
    """Azimuth-derived time fraction in [0, 1) for one VLP-16 revolution
    (the sensor sweeps azimuth linearly in time), from (N, 3) sensor-frame
    points."""
    az = torch.atan2(points[:, 1], points[:, 0])          # [-pi, pi]
    return torch.remainder(az, 2.0 * math.pi) / (2.0 * math.pi)
