"""Plain re-computation of the host engine's odometry step.

``tpu_slam_torch.pipeline.odometry.LidarOdometry`` as the reference's
plain parts compute it, eagerly with host-exit LM loops: the first scan
inserted whole at the initial pose; then for each scan the
constant-velocity prediction clamped to ``max_pred_translation`` /
``max_pred_rotation``, the downsample, the NDT field of the map's window
round the pose the field was built at (it is built on the first scan
after the map changed, round that scan's starting pose, and kept while
the map stands), one NDT registration (the kernel path's schedule:
``ndt.ndt_register``), the gates (a matched fraction under
``min_accept_fraction`` rejects the registration and coasts on the
prediction; an accepted one at ``min_insert_fraction`` or more inserts
the raw cloud) and the insert.

``HostOdometryReference`` keeps its own map (``voxel_map``). ``follow``
advances it with a pose and an insert flag given from outside (the poses
the program returned), registering the scan itself only where asked;
``replace_map`` puts a map rebuilt after a loop and the re-anchored pose
in place. Departures from the port: the insert is at the orthonormalized
pose the program returned (the port inserts at the registration's pose
before its one polar-Newton step, 1e-7 away); the options the
configuration leaves off (pyramid, ICP methods, deskew, occupancy,
scrolling window) are not here and raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from slambench.reference import se3
from slambench.reference.downsample import voxel_downsample
from slambench.reference.ndt import ndt_register
from slambench.reference.odometry import StepResult, ndt_params
from slambench.reference.pointcloud import PointCloud
from slambench.reference.voxel_hash import VoxelGridSpec
from slambench.reference.voxel_map import SparseVoxelMap


def clamped(delta: torch.Tensor, max_t: float, max_r: float) -> torch.Tensor:
    """The constant-velocity step scaled into the clamp (one misconverged
    registration must not throw the next prediction out of its basin)."""
    xi = se3.log(delta)
    t_n = torch.linalg.vector_norm(xi[:3])
    r_n = torch.linalg.vector_norm(xi[3:])
    scale = torch.minimum(
        torch.clamp(max_t / torch.clamp(t_n, min=1e-9), max=1.0),
        torch.clamp(max_r / torch.clamp(r_n, min=1e-9), max=1.0))
    return se3.exp(xi * scale)


class HostOdometryReference:
    """The host engine of one configuration (``odometry``: the
    configuration file's ``odometry`` object)."""

    def __init__(self, odometry: Dict, device):
        for key in ("pyramid_factor", "use_occupancy", "deskew",
                    "scrolling_window"):
            if odometry[key] not in (0, 1, False):
                raise ValueError(f"the host reference has no {key}")
        if odometry["method"] != "ndt":
            raise ValueError("the host reference registers by NDT")
        self.cfg = odometry
        self.device = torch.device(device)
        self.ndt = ndt_params(odometry["ndt"])
        self.map_spec = VoxelGridSpec.centered(
            leaf=odometry["map_leaf"], half_extent=odometry["map_half_extent"])
        self.scan_spec = VoxelGridSpec.centered(
            leaf=odometry["downsample_leaf"],
            half_extent=odometry["map_half_extent"])
        self.map = SparseVoxelMap(self.map_spec, odometry["map_capacity"],
                                  self.device)
        self.pose = None
        self.last_delta = None
        self.field_at = None        # the field's centre; None: stale
        self.index = 0

    def start(self, cloud: PointCloud, pose: torch.Tensor) -> None:
        self.pose = pose.to(torch.float32)
        self.map.insert(cloud.transform(self.pose))
        self.last_delta = torch.eye(4, dtype=torch.float32,
                                    device=self.device)
        self.field_at = None
        self.index = 1

    def downsample(self, cloud: PointCloud) -> PointCloud:
        return voxel_downsample(cloud, self.scan_spec,
                                capacity=self.cfg["scan_capacity"])

    def prediction(self) -> torch.Tensor:
        if not self.cfg["use_constant_velocity"]:
            return self.pose
        return self.pose @ clamped(self.last_delta,
                                   self.cfg["max_pred_translation"],
                                   self.cfg["max_pred_rotation"])

    def register(self, cloud: PointCloud, init_T: torch.Tensor
                 ) -> StepResult:
        field = self.map.field(self.field_at, self.ndt)
        res = ndt_register(self.downsample(cloud), field, self.map_spec,
                           init_T=init_T, params=self.ndt)
        frac = float(res.matched_fraction)
        accepted = frac >= self.cfg["min_accept_fraction"]
        inserted = (accepted and frac >= self.cfg["min_insert_fraction"]
                    and self.index % self.cfg["insert_every"] == 0)
        return StepResult(T=se3.orthonormalize(res.T if accepted else init_T),
                          accepted=accepted, inserted=inserted)

    def follow(self, cloud: PointCloud, T: torch.Tensor, inserted: bool,
               register: bool = False) -> Optional[StepResult]:
        """One step to the given pose and insert flag; with ``register``
        the scan is registered first, from the same prediction and map,
        and that result returned (it does not steer the step)."""
        if self.field_at is None:
            self.field_at = self.pose[:3, 3].clone()
        mine = (self.register(cloud, self.prediction()) if register
                else None)
        T = T.to(torch.float32)
        if inserted:
            self.map.insert(cloud.transform(T))
            self.field_at = None
        self.last_delta = se3.inverse(self.pose) @ T
        self.pose = T
        self.index += 1
        return mine

    def replace_map(self, vmap: SparseVoxelMap, pose: torch.Tensor) -> None:
        """After a loop: the map rebuilt from the keyframes and the pose
        re-anchored on the optimized newest keyframe."""
        self.map = vmap
        self.pose = pose.to(torch.float32)
        self.field_at = None
