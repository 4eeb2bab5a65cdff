"""SLAMSystem on the dense engine with the occupancy layer on (CPU, the
port alone): a checkpoint resume carries the layer and is bit-identical
to the uninterrupted run, and re-anchoring after a loop starts the layer
again at the rebuilt window's origin.

The re-anchor is a named divergence from the reference
(``tpu_slam/pipeline/slam.py``, the dense branch of the loop sweep): it
rebuilds the moment windows at a new origin but keeps ``odom.occ`` with
its old origin and evidence, so that later evictions clear cells the
evidence was not gathered for. The port resets the layer to an empty one
at the rebuilt grid's origin.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph.loop_closure import LoopClosureParams
from tpu_slam_torch.graph.pose_graph import GraphSolveParams
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.pipeline.slam import SLAMSystem
from tpu_slam_torch.pipeline.state import (slam_state_from_numpy,
                                           slam_state_to_numpy,
                                           state_from_numpy, state_to_numpy)
from tpu_slam_torch.registration.icp import ICPParams
from tpu_slam_torch.registration.ndt import NDTParams

N_SCANS = 6
CAP = 4096
DIMS = (24, 24, 8)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores: on two threads the
    port's small CPU ops run as fast as on all of them, and leave the rest
    to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    return SLAMConfig(
        odometry=OdometryConfig(
            scan_capacity=2048, downsample_leaf=0.3, map_leaf=0.5,
            map_half_extent=16.0, map_capacity=16384,
            ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                          window_dims=DIMS),
            pyramid_factor=2, use_occupancy=True, occupancy_steps=32,
            occupancy_max_range=10.0),
        odometry_engine="dense", keyframe_translation=0.4,
        keyframe_rotation=0.25, keyframe_capacity=32,
        keyframe_cloud_capacity=1024, loop_every=2,
        # no loop sweep in this short run: the re-anchor is called directly
        loop=LoopClosureParams(max_distance=1.5, min_index_gap=100,
                               max_candidates=4, min_matched_fraction=0.5,
                               max_error=0.05,
                               icp=ICPParams(max_iterations=25,
                                             max_corr_dist=1.0,
                                             huber_delta=0.3)),
        graph=GraphSolveParams(gn_iterations=6, robust_delta=2.0,
                               robust_kernel="cauchy"),
        edge_capacity=128)


@pytest.fixture(scope="module")
def run():
    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(N_SCANS):
        a = 0.8 * math.pi * k / (N_SCANS - 1)
        T = syn.se2_pose(2.5 * math.cos(a), 2.5 * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=240, noise_std=0.01, rng=rng)
        clouds.append(PointCloud.from_points_host(p[valid], capacity=CAP,
                                                  device="cpu"))
        gt.append(T)
    slam = SLAMSystem(_config(), device="cpu")
    state = slam.init_state(gt[0])
    poses, snaps = [], []
    for c in clouds:
        state, _ = slam.step(state, c)
        poses.append(state.odom.pose.numpy())
        snaps.append(slam_state_to_numpy(state))
    return dict(clouds=clouds, gt=np.stack(gt), poses=np.stack(poses),
                snaps=snaps, state=state)


def test_occupancy_layer_is_carried_in_the_state(run):
    st = run["snaps"][-1]
    occ = st["odom_occ_rows"]
    assert occ.shape == (int(np.prod(DIMS)), 1)
    assert (occ != 0).sum() > 100                    # evidence gathered
    np.testing.assert_array_equal(st["odom_occ_origin_cell"],
                                  st["odom_grid_origin_cell"])
    back = state_to_numpy(state_from_numpy(
        {k[5:]: v for k, v in st.items() if k.startswith("odom_")}, DIMS,
        "cpu"))
    for k in ("occ_rows", "occ_origin_cell", "grid_rows", "wide_rows"):
        np.testing.assert_array_equal(back[k], st["odom_" + k])
    assert np.abs(run["poses"][:, :3, 3] - run["gt"][:, :3, 3]).max() < 0.1


def test_checkpoint_resume_with_occupancy_is_exact(run, tmp_path):
    k = N_SCANS // 2       # resume mid-run, keyframes on both sides
    slam = SLAMSystem(_config(), device="cpu")
    state = slam_state_from_numpy(run["snaps"][k - 1], DIMS, "cpu")
    path = save_checkpoint(str(tmp_path / "ck"), state, scan_index=k)
    resumed, manifest = load_checkpoint(path, device="cpu")
    assert manifest["scan_index"] == k
    assert resumed.odom.occ is not None
    poses = []
    for c in run["clouds"][k:]:
        resumed, _ = slam.step(resumed, c)
        poses.append(resumed.odom.pose.numpy())
    np.testing.assert_array_equal(np.stack(poses), run["poses"][k:])
    final = slam_state_to_numpy(resumed)
    for key, v in slam_state_to_numpy(run["state"]).items():
        np.testing.assert_array_equal(final[key], v, err_msg=key)


def test_reanchor_resets_occupancy_at_the_rebuilt_origin(run):
    """Divergence from the reference, named: after the window rebuild the
    layer is empty and sits at the rebuilt grid's origin (the reference
    keeps the old layer and its old origin)."""
    slam = SLAMSystem(_config(), device="cpu")
    state = slam_state_from_numpy(run["snaps"][-1], DIMS, "cpu")
    n = state.n_keyframes
    assert n >= 3 and float(state.odom.occ.rows.abs().sum()) > 0
    # the optimized newest keyframe 3 m away: the rebuilt windows move
    moved = state.graph.poses.clone()
    moved[n - 1, 0, 3] += 3.0
    state = dataclasses.replace(
        state, graph=dataclasses.replace(state.graph, poses=moved))
    old_origin = state.odom.occ.origin_cell.clone()
    out = slam._reanchor(state)
    assert not torch.equal(out.odom.grid.origin_cell, old_origin)
    assert torch.equal(out.odom.occ.origin_cell, out.odom.grid.origin_cell)
    assert out.odom.occ.rows.shape == state.odom.occ.rows.shape
    assert float(out.odom.occ.rows.abs().sum()) == 0.0
    # without the rebuild the windows stay, and so does the layer
    keep = SLAMSystem(dataclasses.replace(_config(),
                                          rebuild_map_after_loop=False),
                      device="cpu")._reanchor(state)
    assert keep.odom.occ is state.odom.occ
