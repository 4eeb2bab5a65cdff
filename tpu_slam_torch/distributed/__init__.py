"""Multi-device scaling over ranks of torch.distributed.

Port of ``tpu_slam.distributed``, one rank per device (the body of each of
the reference's ``shard_map``s is what a rank runs; ``mesh`` holds the
collectives):

  * DP: independent registrations (odometry pairs, loop-closure candidate
    verification) sharded over the ranks (registration_dist);
  * SP-analog: the pose graph solved by keyframe-range-sharded exact
    Schur-complement elimination (schur), and an edge-sharded PCG with
    all-reduced partial sums (pose_graph_dist) for loop-dense graphs;
  * TP-analog: the voxel map sharded by x-slab with NDT against it
    (map_shard), and the dense-window odometry step sharded by x-chunk
    (dense_shard);
  * multi-host: process-group bring-up and the heartbeat (multihost).
"""

from tpu_slam_torch.distributed.mesh import device_count, make_mesh
from tpu_slam_torch.distributed.pose_graph_dist import \
    optimize_pose_graph_sharded
from tpu_slam_torch.distributed.registration_dist import sharded_pairwise_icp
from tpu_slam_torch.distributed.schur import optimize_pose_graph_schur

__all__ = [
    "make_mesh",
    "device_count",
    "sharded_pairwise_icp",
    "optimize_pose_graph_sharded",
    "optimize_pose_graph_schur",
]
