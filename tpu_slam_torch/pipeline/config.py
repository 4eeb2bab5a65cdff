"""Configuration of the odometry pipeline.

Port of ``tpu_slam.pipeline.config.OdometryConfig``: the same fields and
defaults, as a frozen dataclass. ``ICPParams`` is a copy of the reference's
dataclass (the ICP engine itself is not ported yet); ``SLAMConfig`` waits
for the SLAM port.
"""

from __future__ import annotations

import dataclasses

from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.registration.ndt import NDTParams


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """Static ICP configuration (copy of the reference's fields)."""

    max_iterations: int = 30
    tolerance: float = 1e-4
    max_corr_dist: float = 1.0
    huber_delta: float = 0.5
    point_to_plane: bool = False
    damping: float = 1e-6
    nn_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-map odometry configuration."""

    # Input handling
    scan_capacity: int = 32768          # padded size of downsampled scans
    downsample_leaf: float = 0.2        # scan voxel-downsample leaf (m)
    scan_max_range: float = 0.0         # horizontal range gate on the
                                        # registration input (0 = off)
    insert_downsampled: bool = False    # integrate the downsampled scan
                                        # instead of the raw cloud

    # Map
    map_leaf: float = 0.5               # map voxel leaf (m)
    map_half_extent: float = 100.0      # world half-extent covered by keys
    map_capacity: int = 131072          # max occupied voxels (sparse map)
    scrolling_window: bool = False      # sparse map: sensor-following window
    rebase_fraction: float = 0.25       # re-center once the sensor leaves
                                        # the central (1 - 2f) core

    # Registration
    method: str = "ndt"                 # 'ndt' | 'icp_point' | 'icp_plane'
    ndt: NDTParams = NDTParams(max_iterations=30)
    icp: ICPParams = ICPParams(max_iterations=30, max_corr_dist=1.0)
    pyramid_factor: int = 0             # coarse NDT stage on a factor-x
                                        # coarser, wider field (0 = off)

    # Occupancy maintenance (free-space evidence -> dynamic-point removal)
    use_occupancy: bool = False
    occupancy_capacity: int = 65536
    occupancy_steps: int = 64
    occupancy_max_range: float = 30.0
    occupancy_evict_below: float = -1.0

    # Motion model / insertion policy
    deskew: bool = False                # undistort scans with the predicted
                                        # motion (VLP-16 azimuth timing)
    use_constant_velocity: bool = True
    max_pred_translation: float = 0.7   # clamp on CV-extrapolated motion (m)
    max_pred_rotation: float = 0.3      # ... and rotation (rad)
    insert_every: int = 1               # integrate every k-th scan into map
    min_insert_fraction: float = 0.4    # skip map insert below this matched
                                        # fraction
    min_accept_fraction: float = 0.3    # below this, reject the registration
                                        # and coast on the prediction

    def map_spec(self) -> VoxelGridSpec:
        return VoxelGridSpec.centered(leaf=self.map_leaf,
                                      half_extent=self.map_half_extent)

    def scan_spec(self) -> VoxelGridSpec:
        return VoxelGridSpec.centered(leaf=self.downsample_leaf,
                                      half_extent=self.map_half_extent)
