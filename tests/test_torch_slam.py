"""The port's SLAMSystem (dense engine) against tpu_slam's, as a whole (CPU).

The reference runs once per module on 16 office scans along a closed
circle, with its NDT terms kernel swapped for
``ndt_terms_raster_reference`` (as in test_torch_odometry_dense) and NN on
its XLA tier; its SLAM state is snapshot as numpy before every step. The
port then runs (1) the same scans from the same first scan, (2) one step
from the reference's own state just before the first loop sweep that
accepts a loop, and (3) a checkpoint round trip against its own
uninterrupted run. The config uses the default re-anchor + window-rebuild
branch after a loop.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.graph.loop_closure import LoopClosureParams as JLoop
from tpu_slam.graph.pose_graph import GraphSolveParams as JGraph
from tpu_slam.pipeline.config import OdometryConfig as JOdom
from tpu_slam.pipeline.config import SLAMConfig as JSLAMConfig
from tpu_slam.pipeline.slam import SLAMSystem as JSLAM
from tpu_slam.registration.icp import ICPParams as JICP
from tpu_slam.registration.ndt import NDTParams as JNDT
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.nn_search import nearest_neighbors
from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.slam import SLAMSystem
from tpu_slam_torch.pipeline.state import (slam_config_from_dict,
                                           slam_state_from_numpy,
                                           slam_state_to_numpy)

N_SCANS = 16
CAP = 4096
DIMS = (24, 24, 8)


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    return j_terms.ndt_terms_raster_reference(raster, planes, T, gamma,
                                              max_corr_dist, dims, q_cap)


def _jconfig():
    return JSLAMConfig(
        odometry=JOdom(scan_capacity=2048, downsample_leaf=0.3, map_leaf=0.5,
                       map_half_extent=16.0, map_capacity=16384,
                       ndt=JNDT(max_iterations=10, coarse_iterations=2,
                                window_dims=DIMS,
                                terms_impl="pallas_interpret"),
                       pyramid_factor=2),
        odometry_engine="dense", keyframe_translation=0.4,
        keyframe_rotation=0.25, keyframe_capacity=32,
        keyframe_cloud_capacity=1024, loop_every=2,
        loop=JLoop(max_distance=1.5, min_index_gap=6, max_candidates=4,
                   min_matched_fraction=0.5, max_error=0.05,
                   icp=JICP(max_iterations=25, max_corr_dist=1.0,
                            huber_delta=0.3, nn_impl="xla")),
        graph=JGraph(gn_iterations=6, robust_delta=2.0,
                     robust_kernel="cauchy"),
        edge_capacity=128)


def _jstate_numpy(s):
    """A reference SLAMState as the dict of pipeline.state."""
    a = np.array
    d = {}
    if s.odom is not None:
        o = s.odom
        d.update(odom_pose=a(o.pose), odom_last_delta=a(o.last_delta),
                 odom_grid_rows=a(o.grid.rows),
                 odom_grid_origin_cell=a(o.grid.origin_cell),
                 odom_wide_rows=a(o.wide.rows),
                 odom_wide_origin_cell=a(o.wide.origin_cell),
                 odom_scan_index=a(o.scan_index),
                 odom_last_metrics=a(o.last_metrics))
    g = s.graph
    d.update(graph_poses=a(g.poses), graph_n_nodes=a(g.n_nodes),
             graph_edge_i=a(g.edge_i), graph_edge_j=a(g.edge_j),
             graph_edge_T=a(g.edge_T), graph_edge_info=a(g.edge_info),
             graph_edge_mask=a(g.edge_mask), kf_points=a(s.kf_points),
             kf_mask=a(s.kf_mask), kf_intensity=a(s.kf_intensity),
             kf_normals=a(s.kf_normals), kf_desc=a(s.kf_desc),
             n_keyframes=s.n_keyframes, last_kf_pose=a(s.last_kf_pose),
             n_loop_closures=s.n_loop_closures, n_evictions=s.n_evictions,
             archived_poses=(np.stack(s.archived_poses) if s.archived_poses
                             else np.zeros((0, 4, 4), np.float32)),
             loop_pairs=np.asarray(sorted(s.loop_pairs)).reshape(-1, 2),
             tried_pairs=np.asarray([(i, j, v) for (i, j), v in
                                     sorted(s.tried_pairs.items())]
                                    ).reshape(-1, 3))
    return d


@pytest.fixture(scope="module")
def oracle():
    world = syn.default_office()
    rng = np.random.default_rng(0)
    pts, gt = [], []
    for k in range(N_SCANS):
        a = 2 * math.pi * k / (N_SCANS - 1)
        T = syn.se2_pose(2.5 * math.cos(a), 2.5 * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=240, noise_std=0.01, rng=rng)
        pts.append(p[valid])
        gt.append(T)
    gt = np.stack(gt)
    jcfg = _jconfig()
    before, loops = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_terms, "ndt_terms_raster", _reference_terms)
        slam = JSLAM(jcfg)
        state = slam.init_state(jnp.asarray(gt[0], jnp.float32))
        poses = []
        for p in pts:
            before.append(_jstate_numpy(state))
            state, _ = slam.step(state, JCloud.from_points_host(p,
                                                                capacity=CAP))
            poses.append(np.array(state.odom.pose))
            loops.append(state.n_loop_closures)
        after = _jstate_numpy(state)
    return dict(pts=pts, gt=gt, cfg=jcfg, before=before, after=after,
                loops=loops, poses=np.stack(poses), jslam=slam)


def _system(oracle, **replace):
    cfg = slam_config_from_dict(dataclasses.asdict(oracle["cfg"]))
    return SLAMSystem(dataclasses.replace(cfg, **replace), device="cpu")


def _clouds(oracle):
    return [PointCloud.from_points_host(p, capacity=CAP, device="cpu")
            for p in oracle["pts"]]


@pytest.fixture(scope="module")
def port_run(oracle):
    slam = _system(oracle)
    launches = nearest_neighbors.launches
    state = slam.init_state(oracle["gt"][0])
    poses, snaps = [], []
    for c in _clouds(oracle):
        state, _ = slam.step(state, c)
        poses.append(state.odom.pose.numpy())
        snaps.append(slam_state_to_numpy(state))
    assert nearest_neighbors.launches == launches     # CPU: plain version
    return dict(poses=np.stack(poses), state=state, snaps=snaps,
                stage_seconds=dict(slam.stage_seconds))


def test_reference_run_closes_loops(oracle):
    assert oracle["after"]["n_keyframes"] >= 12
    assert oracle["after"]["n_loop_closures"] >= 1


def test_short_run_matches_reference(oracle, port_run):
    ref, st = oracle["after"], slam_state_to_numpy(port_run["state"])
    assert st["n_keyframes"] == ref["n_keyframes"]
    np.testing.assert_array_equal(st["loop_pairs"], ref["loop_pairs"])
    np.testing.assert_array_equal(st["tried_pairs"], ref["tried_pairs"])
    assert st["n_loop_closures"] == ref["n_loop_closures"]
    n = int(ref["n_keyframes"])
    gp, rp = st["graph_poses"][:n], ref["graph_poses"][:n]
    # Each node is the odometry pose of its scan, and the odometry of the
    # two sides agrees only to a few LM stopping steps a scan: a float32
    # cost difference can flip one accept/reject (test_torch_odometry_dense).
    # In this small (24, 24, 8) window such a flip moved one scan 9.6e-3 m,
    # and the graph nodes ended up to 9.2e-3 m and 2.4e-3 (rotation entries)
    # apart (measured). So positions are held to 2.5e-2 m and rotations to
    # 5e-3; the graph solve alone is held to 1e-4 in
    # test_one_step_from_reference_state.
    np.testing.assert_allclose(gp[:, :3, 3], rp[:, :3, 3], atol=2.5e-2)
    np.testing.assert_allclose(gp[:, :3, :3], rp[:, :3, :3], atol=5e-3)
    for k in ("graph_edge_i", "graph_edge_j", "graph_edge_mask"):
        np.testing.assert_array_equal(st[k], ref[k])
    assert ate_rmse(port_run["poses"], oracle["gt"], align=False) < 0.05
    assert all(v > 0 for v in port_run["stage_seconds"].values())


def _first_accepting_step(oracle):
    loops = [0] + oracle["loops"]
    return next(k for k in range(N_SCANS) if loops[k + 1] > loops[k])


def test_one_step_from_reference_state(oracle):
    """Seed the port with the reference's state just before the step whose
    loop sweep first accepts a loop; the step must accept the same pairs,
    reject the same pairs and land on the same graph."""
    k = _first_accepting_step(oracle)
    slam = _system(oracle)
    state = slam_state_from_numpy(oracle["before"][k], DIMS, "cpu")
    state, m = slam.step(state, _clouds(oracle)[k])
    ref = (oracle["before"][k + 1] if k + 1 < N_SCANS else oracle["after"])
    st = slam_state_to_numpy(state)
    assert m.is_keyframe and m.n_loop_closures > 0
    np.testing.assert_array_equal(st["loop_pairs"], ref["loop_pairs"])
    np.testing.assert_array_equal(st["tried_pairs"], ref["tried_pairs"])
    n = int(ref["n_keyframes"])
    assert st["n_keyframes"] == n
    # one odometry step (within a few LM stopping steps, 2e-3 here) feeds
    # the newest node; the graph solve itself agrees to 1e-4 on the nodes
    # the step did not add
    np.testing.assert_allclose(st["graph_poses"][:n - 1],
                               ref["graph_poses"][:n - 1], atol=1e-4)
    np.testing.assert_allclose(st["graph_poses"][n - 1],
                               ref["graph_poses"][n - 1], atol=2e-3)
    np.testing.assert_allclose(st["odom_pose"], ref["odom_pose"], atol=2e-3)
    np.testing.assert_array_equal(st["odom_grid_origin_cell"],
                                  ref["odom_grid_origin_cell"])


def test_checkpoint_resume_is_exact(oracle, port_run, tmp_path):
    # resume mid-run, so the resumed part holds the loop sweeps
    k = N_SCANS // 2
    assert k <= _first_accepting_step(oracle)
    slam = _system(oracle)
    state = slam_state_from_numpy(port_run["snaps"][k - 1], DIMS, "cpu")
    path = save_checkpoint(str(tmp_path / "ck"), state, scan_index=k)
    resumed, manifest = load_checkpoint(path, device="cpu")
    assert manifest["scan_index"] == k and manifest["engine"] == "dense"
    clouds = _clouds(oracle)
    poses = []
    for c in clouds[k:]:
        resumed, _ = slam.step(resumed, c)
        poses.append(resumed.odom.pose.numpy())
    np.testing.assert_array_equal(np.stack(poses), port_run["poses"][k:])
    final = slam_state_to_numpy(resumed)
    for key, v in slam_state_to_numpy(port_run["state"]).items():
        np.testing.assert_array_equal(final[key], v, err_msg=key)


def test_checkpoint_refuses_other_formats(tmp_path):
    path = tmp_path / "other.npz"
    np.savez(path, manifest='{"format_version": 3}',
             graph_poses=np.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(str(path), device="cpu")


def test_slide_window_matches_reference(oracle):
    """Fixed-lag eviction on the same full state, in both packages."""
    jslam = oracle["jslam"]
    from tpu_slam.pipeline.slam import SLAMState as JState
    from tpu_slam.graph.pose_graph import PoseGraph as JGraphState

    d = oracle["after"]
    jstate = JState(
        odom=None,
        graph=JGraphState(poses=jnp.asarray(d["graph_poses"]),
                          n_nodes=jnp.int32(d["graph_n_nodes"]),
                          edge_i=jnp.asarray(d["graph_edge_i"]),
                          edge_j=jnp.asarray(d["graph_edge_j"]),
                          edge_T=jnp.asarray(d["graph_edge_T"]),
                          edge_info=jnp.asarray(d["graph_edge_info"]),
                          edge_mask=jnp.asarray(d["graph_edge_mask"])),
        kf_points=jnp.asarray(d["kf_points"]),
        kf_mask=jnp.asarray(d["kf_mask"]),
        kf_intensity=jnp.asarray(d["kf_intensity"]),
        kf_normals=jnp.asarray(d["kf_normals"]),
        kf_desc=jnp.asarray(d["kf_desc"]),
        n_keyframes=int(d["n_keyframes"]),
        last_kf_pose=jnp.asarray(d["last_kf_pose"]),
        n_loop_closures=int(d["n_loop_closures"]),
        loop_pairs={(int(i), int(j)) for i, j in d["loop_pairs"]},
        tried_pairs={(int(i), int(j)): int(v)
                     for i, j, v in d["tried_pairs"]})
    slam = _system(oracle)
    state = slam_state_from_numpy(d, DIMS, "cpu")
    got = slam_state_to_numpy(slam._slide_window(state))
    ref = _jstate_numpy(jslam._slide_window(jstate))
    assert got["n_evictions"] == ref["n_evictions"] > 0
    for key, v in ref.items():
        if not key.startswith("odom_"):
            np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_system_refuses_what_is_not_ported(oracle):
    with pytest.raises(NotImplementedError):
        _system(oracle, odometry_engine="host")
    assert _system(oracle).device == torch.device("cpu")
