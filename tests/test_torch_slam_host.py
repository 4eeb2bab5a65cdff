"""The port's SLAMSystem on the host engine (``odometry_engine="host"``,
the sparse voxel map) against tpu_slam's, on the reference's own SLAM
workload (tests/test_pipeline.py: the office circle), CPU.

Held to: over the first scans of the run, the keyframe count, the
keyframe clouds, the graph's edges and the loop sweeps' records
(``collect_loop_debug``) equal the reference's; the first registration
within 1e-4 m, the later poses within 2 cm and the ATE within 0.005 m of
the reference's (each registration's LM runs to its cap on steps below
the cost's float32 resolution, where the order of the sums decides each
accept, and the differences carry on through the constant-velocity
prediction); ``_rebuild_map_batched`` (one insert of every keyframe point
into an empty map) against the reference's on the same keyframes (keys,
counts and stamps exact) and against the per-keyframe insert loop
(keys exact, counts within 1e-5 relative, as the reference's own test);
a checkpoint resume with occupancy on bit-identical to the uninterrupted
run.

Named divergence (a reference fault the port fixes): the reference's
checkpoint of the host engine keeps only pose, last delta and the map
(``tpu_slam/pipeline/checkpoint.py``), so a resumed run with occupancy on
has no grid and fails at its first occupancy update. The port's
checkpoint carries the grid's keys and log-odds.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.graph.loop_closure import LoopClosureParams as JLoop
from tpu_slam.graph.pose_graph import GraphSolveParams as JGraph
from tpu_slam.pipeline import slam as jslam_mod
from tpu_slam.pipeline.config import OdometryConfig as JConfig
from tpu_slam.pipeline.config import SLAMConfig as JSLAMConfig
from tpu_slam.registration.icp import ICPParams as JICP
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.mapping.voxel_map import empty_map, insert_cloud
from tpu_slam_torch.pipeline import slam as slam_mod
from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.slam import SLAMSystem
from tpu_slam_torch.pipeline.state import (slam_config_from_dict,
                                           slam_state_to_numpy)

N_SCANS = 18
CAP = 16384


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(**odo):
    """The reference's _slam_cfg (tests/test_pipeline.py), terms pinned to
    the sparse path."""
    return JSLAMConfig(
        odometry=JConfig(scan_capacity=4096, downsample_leaf=0.3,
                         map_leaf=0.5, map_half_extent=16.0,
                         map_capacity=16384,
                         ndt=JParams(max_iterations=25, terms_impl="xla"),
                         **odo),
        keyframe_translation=0.4, keyframe_rotation=0.25,
        keyframe_capacity=64, keyframe_cloud_capacity=2048, loop_every=4,
        loop=JLoop(max_distance=1.5, min_index_gap=8, max_candidates=4,
                   min_matched_fraction=0.5, max_error=0.05,
                   icp=JICP(max_iterations=25, max_corr_dist=1.0,
                            huber_delta=0.3, nn_impl="xla")),
        graph=JGraph(gn_iterations=6, robust_delta=2.0,
                     robust_kernel="cauchy"),
        edge_capacity=256)


def _circle(n_poses=40, n_azimuth=240, take=N_SCANS):
    """The reference's full-loop sequence; its first ``take`` scans."""
    world = syn.default_office()
    rng = np.random.default_rng(0)
    gt, pts = [], []
    for k in range(n_poses):
        a = 2 * math.pi * k / (n_poses - 1)
        T = syn.se2_pose(2.5 * math.cos(a), 2.5 * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.01, rng=rng)
        gt.append(T)
        pts.append(p[valid])
    return pts[:take], np.stack(gt)[:take]


def _port(jcfg):
    return SLAMSystem(slam_config_from_dict(dataclasses.asdict(jcfg)),
                      device="cpu")


def _tcloud(p):
    return PointCloud.from_points_host(p, capacity=CAP, device="cpu")


@pytest.fixture(scope="module")
def oracle():
    pts, gt = _circle()
    jcfg = _jcfg()
    js = jslam_mod.SLAMSystem(jcfg)
    js.collect_loop_debug = True
    state = js.init_state(jnp.asarray(gt[0], jnp.float32))
    poses = []
    for p in pts:
        state, _ = js.step(state, JCloud.from_points(jnp.asarray(p), CAP))
        poses.append(np.array(state.odom.pose))
    return dict(pts=pts, gt=gt, jcfg=jcfg, poses=np.stack(poses),
                state=state, loop_debug=js.loop_debug)


@pytest.fixture(scope="module")
def port_run(oracle):
    slam = _port(oracle["jcfg"])
    slam.collect_loop_debug = True
    state = slam.init_state(oracle["gt"][0])
    poses = []
    for p in oracle["pts"]:
        state, _ = slam.step(state, _tcloud(p))
        poses.append(state.odom.pose.numpy())
    return dict(slam=slam, state=state, poses=np.stack(poses))


def test_host_slam_matches_reference(oracle, port_run):
    js, ts = oracle["state"], port_run["state"]
    n = ts.n_keyframes
    assert n == js.n_keyframes >= 6
    np.testing.assert_allclose(port_run["poses"][1], oracle["poses"][1],
                               atol=1e-4)
    np.testing.assert_allclose(port_run["poses"], oracle["poses"],
                               atol=2e-2)
    gt = oracle["gt"]
    assert abs(ate_rmse(port_run["poses"], gt, align=False)
               - ate_rmse(oracle["poses"], gt, align=False)) < 0.005
    np.testing.assert_array_equal(ts.kf_mask.numpy(),
                                  np.asarray(js.kf_mask))
    m = ts.kf_mask.numpy()
    np.testing.assert_array_equal(ts.kf_points.numpy()[m],
                                  np.asarray(js.kf_points)[m])
    for f in ("edge_i", "edge_j", "edge_mask"):
        np.testing.assert_array_equal(getattr(ts.graph, f).numpy(),
                                      np.asarray(getattr(js.graph, f)))
    assert int(ts.graph.n_nodes) == int(js.graph.n_nodes) == n
    # the loop sweeps ran and proposed the same (here: no) pairs
    assert port_run["slam"].loop_debug == oracle["loop_debug"]
    assert len(oracle["loop_debug"]) >= 1


def test_rebuild_map_batched_matches_reference_and_loop(oracle, port_run):
    ts = port_run["state"]
    n = ts.n_keyframes
    cfg = port_run["slam"].config.odometry
    spec = cfg.map_spec()
    before = insert_cloud.fallbacks + insert_cloud.incremental
    batched = slam_mod._rebuild_map_batched(
        ts.graph.poses, ts.kf_points, ts.kf_mask, n, spec=spec,
        capacity=cfg.map_capacity)
    assert insert_cloud.fallbacks + insert_cloud.incremental == before + 1
    ref = jslam_mod._rebuild_map_batched(
        jnp.asarray(ts.graph.poses.numpy()), jnp.asarray(ts.kf_points.numpy()),
        jnp.asarray(ts.kf_mask.numpy()), jnp.int32(n),
        spec=oracle["jcfg"].odometry.map_spec(),
        capacity=cfg.map_capacity)
    for f in ("keys", "count", "stamp"):
        np.testing.assert_array_equal(getattr(batched, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert set(batched.stamp[batched.occupied_mask()].tolist()) == {float(n)}

    seq = empty_map(cfg.map_capacity, device="cpu")
    for k in range(n):
        cloud = PointCloud(points=ts.kf_points[k], mask=ts.kf_mask[k])
        seq = insert_cloud(seq, cloud.transform(ts.graph.poses[k]), spec,
                           stamp=float(n))
    kb, ks = batched.keys.numpy(), seq.keys.numpy()
    np.testing.assert_array_equal(np.sort(kb), np.sort(ks))
    np.testing.assert_allclose(batched.count.numpy()[np.argsort(kb)],
                               seq.count.numpy()[np.argsort(ks)], rtol=1e-5)


def test_checkpoint_resume_with_occupancy_is_exact(oracle, tmp_path):
    """The port's host checkpoint carries the occupancy grid: a resume is
    bit-identical to the uninterrupted run. The reference's drops it (the
    named divergence)."""
    jcfg = _jcfg(use_occupancy=True, occupancy_capacity=32768,
                 occupancy_steps=32, occupancy_max_range=10.0)
    pts = oracle["pts"][:6]
    slam = _port(jcfg)
    state = slam.init_state(oracle["gt"][0])
    snaps, poses = [], []
    for p in pts:
        state, _ = slam.step(state, _tcloud(p))
        snaps.append(state)
        poses.append(state.odom.pose.numpy())
    assert int((snaps[-1].odom.occ.log_odds != 0).sum()) > 100

    k = 3
    path = save_checkpoint(str(tmp_path / "host"), snaps[k - 1],
                           scan_index=k)
    resumed, manifest = load_checkpoint(path, device="cpu")
    assert manifest["engine"] == "host" and manifest["scan_index"] == k
    np.testing.assert_array_equal(resumed.odom.occ.keys.numpy(),
                                  snaps[k - 1].odom.occ.keys.numpy())
    fresh = _port(jcfg)
    got = []
    for p in pts[k:]:
        resumed, _ = fresh.step(resumed, _tcloud(p))
        got.append(resumed.odom.pose.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(poses[k:]))
    final, want = (slam_state_to_numpy(resumed),
                   slam_state_to_numpy(snaps[-1]))
    assert final.keys() == want.keys()
    for key, v in want.items():
        np.testing.assert_array_equal(final[key], v, err_msg=key)

    # the reference's checkpoint of the same state comes back without its
    # grid
    from tpu_slam.mapping.occupancy import empty_occupancy
    from tpu_slam.pipeline.checkpoint import load_checkpoint as j_load
    from tpu_slam.pipeline.checkpoint import save_checkpoint as j_save
    from tpu_slam.pipeline.odometry import OdometryState as JState
    from tpu_slam.mapping.voxel_map import empty_map as j_empty_map

    js = jslam_mod.SLAMSystem(jcfg).init_state()
    js = dataclasses.replace(js, odom=JState(
        pose=js.odom.pose, last_delta=js.odom.last_delta,
        vmap=j_empty_map(64), scan_index=3, occ=empty_occupancy(64)))
    jpath = j_save(str(tmp_path / "ref.npz"), js)
    assert j_load(jpath)[0].odom.occ is None
