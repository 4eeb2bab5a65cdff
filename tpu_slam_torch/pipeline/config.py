"""Configuration of the odometry and SLAM pipelines.

Port of ``tpu_slam.pipeline.config``: ``OdometryConfig`` and ``SLAMConfig``
with the reference's fields and defaults, as frozen dataclasses.
``ICPParams`` lives in ``registration.icp``, as in the reference.
"""

from __future__ import annotations

import dataclasses

from tpu_slam_torch.graph.loop_closure import LoopClosureParams
from tpu_slam_torch.graph.pose_graph import GraphSolveParams
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.registration.icp import ICPParams
from tpu_slam_torch.registration.ndt import NDTParams


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


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Full SLAM system configuration (odometry + graph backend)."""

    odometry: OdometryConfig = OdometryConfig()
    odometry_engine: str = "host"       # 'host' (sparse-map engine, not
                                        # ported yet) | 'dense' (the
                                        # dense-window engine; needs
                                        # odometry.ndt.window_dims)

    # Keyframe policy
    keyframe_translation: float = 0.5   # new keyframe after this motion (m)
    keyframe_rotation: float = 0.3      # ... or this rotation (rad)
    keyframe_capacity: int = 512
    keyframe_cloud_capacity: int = 8192  # stored downsampled points per kf
    window_evict_fraction: float = 0.25  # fixed-lag window: when keyframe or
                                        # edge capacity fills, this fraction
                                        # of the oldest keyframes is evicted
                                        # (their poses archived first)

    # Loop closure / graph
    loop_every: int = 5                 # run detection every k keyframes
    loop: LoopClosureParams = LoopClosureParams()
    # robust (redescending Cauchy) kernel on by default: one wrong accepted
    # closure must not fold the trajectory
    graph: GraphSolveParams = GraphSolveParams(gn_iterations=8,
                                               robust_delta=2.0,
                                               robust_kernel="cauchy")
    edge_capacity: int = 2048
    odom_edge_info: float = 100.0       # information weight of odometry edges
    loop_edge_info: float = 25.0        # loop-closure edge weight
    rebuild_map_after_loop: bool = True
    reanchor_after_loop: bool = True    # False = loosely coupled: the graph
                                        # keeps the optimized trajectory and
                                        # odometry free-runs
