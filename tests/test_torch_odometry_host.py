"""The port's LidarOdometry (the sparse voxel-map engine) against
tpu_slam's, on the office arc of the reference's own pipeline tests (CPU).

The reference engine runs once per configuration; its state is snapshot
as numpy after each step, so the port can start a step from the
reference's own state. Held to: one step from the reference's state on
each registration method (``ndt`` on the sparse path and on the kernel
path, ``icp_point``, ``icp_plane``) with poses within 1e-4 m / 1e-4 rad
and iterations exact (on the sparse path on the first step: later, the LM
tail's last accept can flip on a last-bit difference of the sums); a
whole short run (poses within 1e-4 on the steps where no LM accept flips,
the ATE within 0.005 m of the reference's); the
number of field builds; and a run with the scrolling window (rebases),
deskew and occupancy all on, with the map offset, the occupancy grid and
the map's keys and counts equal to the reference's.

``terms_impl`` is pinned on both sides: the port's "xla" against the
reference's "xla" (its CPU default), the port's "auto" (its kernel path on
every device: a named divergence, the reference's "auto" takes the kernel
path only on its accelerator) against the reference's "pallas_interpret"
with ``ndt_terms_raster_reference`` swapped in for its kernel.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.mapping.occupancy import OccupancyGrid as JOcc
from tpu_slam.mapping.voxel_map import VoxelMap as JMap
from tpu_slam.pipeline.config import OdometryConfig as JConfig
from tpu_slam.pipeline.metrics import ate_rmse as j_ate
from tpu_slam.pipeline.odometry import LidarOdometry as JOdometry
from tpu_slam.pipeline.odometry import OdometryState as JState
from tpu_slam.registration.icp import ICPParams as JICP
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.odometry import LidarOdometry
from tpu_slam_torch.pipeline.state import (config_from_dict,
                                           host_state_from_numpy,
                                           host_state_to_numpy)

N_SCANS = 5
MAP_FIELDS = ("keys", "count", "sum_pts", "sum_outer", "stamp")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    return j_terms.ndt_terms_raster_reference(raster, planes, T, gamma,
                                              max_corr_dist, dims, q_cap)


def _jconfig(**kw):
    """The reference's ODOM_CFG (tests/test_pipeline.py), terms pinned."""
    base = dict(scan_capacity=4096, downsample_leaf=0.3, map_leaf=0.5,
                map_half_extent=16.0, map_capacity=16384,
                ndt=JParams(max_iterations=25, terms_impl="xla"))
    return JConfig(**{**base, **kw})


def _arc(n_poses=N_SCANS, radius=2.5, n_azimuth=360, seed=0,
         arc_fraction=0.25):
    """The reference's _sequence: VLP-16 scans along an arc in the office."""
    world = syn.default_office()
    rng = np.random.default_rng(seed)
    gt, pts = [], []
    for k in range(n_poses):
        a = 2 * math.pi * arc_fraction * k / max(n_poses - 1, 1)
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.01, rng=rng)
        gt.append(T)
        pts.append(p[valid])
    return pts, np.stack(gt)


def _jstate_numpy(s):
    d = {"pose": np.array(s.pose), "last_delta": np.array(s.last_delta),
         "scan_index": np.int64(s.scan_index),
         "map_offset": (None if s.map_offset is None
                        else np.array(s.map_offset, np.float64)),
         "occ_keys": None if s.occ is None else np.array(s.occ.keys),
         "occ_log_odds": None if s.occ is None else np.array(s.occ.log_odds)}
    for f in MAP_FIELDS:
        d["map_" + f] = np.array(getattr(s.vmap, f))
    return d


def _jstate_from(d):
    occ = None
    if d["occ_keys"] is not None:
        occ = JOcc(keys=jnp.asarray(d["occ_keys"]),
                   log_odds=jnp.asarray(d["occ_log_odds"]))
    return JState(pose=jnp.asarray(d["pose"]),
                  last_delta=jnp.asarray(d["last_delta"]),
                  vmap=JMap(**{f: jnp.asarray(d["map_" + f])
                               for f in MAP_FIELDS}),
                  scan_index=int(d["scan_index"]), occ=occ,
                  map_offset=(None if d["map_offset"] is None
                              else np.array(d["map_offset"])))


def _run_reference(jcfg, pts, gt, builds=None):
    """The reference engine over the scans: (poses, states before each
    step and after the last, metrics); ``builds`` counts field builds."""
    odo = JOdometry(jcfg)
    if builds is not None:
        orig = odo._build_fields

        def counted(*a, **k):
            builds.append(1)
            return orig(*a, **k)
        odo._build_fields = counted
    s = odo.init_state(jnp.asarray(gt[0], jnp.float32))
    snaps, poses = [], []
    for p in pts:
        snaps.append(_jstate_numpy(s))
        s, _ = odo.step(s, JCloud.from_points(jnp.asarray(p),
                                              capacity=16384))
        poses.append(np.array(s.pose))
    snaps.append(_jstate_numpy(s))
    return np.stack(poses), snaps, odo.metrics.records


def _tclouds(pts):
    return [PointCloud.from_points_host(p, capacity=16384, device="cpu")
            for p in pts]


def _pose_err(a, b):
    d = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(a) @ b)))
    return np.linalg.norm(d[:3]), np.linalg.norm(d[3:])


@pytest.fixture(scope="module")
def oracle():
    pts, gt = _arc()
    jcfg = _jconfig()
    builds = []
    poses, snaps, records = _run_reference(jcfg, pts, gt, builds)
    return dict(pts=pts, gt=gt, jcfg=jcfg, poses=poses, snaps=snaps,
                records=records, builds=len(builds))


def _port_step(cfg, snap, pts):
    odo = LidarOdometry(cfg, device="cpu")
    s, m = odo.step(host_state_from_numpy(snap, "cpu"),
                    _tclouds([pts])[0])
    return s, m


def _ref_step(jcfg, snap, pts):
    odo = JOdometry(jcfg)
    s, m = odo.step(_jstate_from(snap), JCloud.from_points(
        jnp.asarray(pts), capacity=16384))
    return s, m


def test_state_round_trip(oracle):
    d = oracle["snaps"][2]
    back = host_state_to_numpy(host_state_from_numpy(d, "cpu"))
    for k, v in d.items():
        if v is None:
            assert back[k] is None, k
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("k", [1, 2])
def test_ndt_sparse_step_from_reference_state(oracle, k):
    cfg = config_from_dict(dataclasses.asdict(oracle["jcfg"]))
    assert cfg.ndt.terms_impl == "xla"
    s, m = _port_step(cfg, oracle["snaps"][k], oracle["pts"][k])
    ref = oracle["records"][k]
    # iterations exact on the first step; on a later one the LM tail (steps
    # of < 1e-4 m) may end on another accept, the pose still within 1e-4
    if k == 1:
        assert m.iterations == ref.iterations
    assert m.matched_fraction == pytest.approx(ref.matched_fraction,
                                               abs=1e-5)
    et, er = _pose_err(oracle["poses"][k], s.pose.numpy())
    assert et < 1e-4 and er < 1e-4
    if k == 1:
        # the scan was accepted and inserted at the same pose: the map's
        # keys and counts exact
        np.testing.assert_array_equal(s.vmap.keys.numpy(),
                                      oracle["snaps"][k + 1]["map_keys"])
        np.testing.assert_array_equal(s.vmap.count.numpy(),
                                      oracle["snaps"][k + 1]["map_count"])


def test_ndt_kernel_path_step_from_reference_state(oracle, monkeypatch):
    """The kernel path: the 32-cell cube window (window_bits 5) of the
    64-cell grid, around the pose."""
    monkeypatch.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    jcfg = _jconfig(ndt=JParams(max_iterations=25, window_bits=5,
                                terms_impl="pallas_interpret"))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.ndt.terms_impl == "auto"
    # the first registration: on later ones the LM tail's steps (< 1e-4 m,
    # a cost change below the cost's float32 resolution) accept or reject
    # on the sums' last bits, and the two orders of summation part there
    snap, p = oracle["snaps"][1], oracle["pts"][1]
    js, jm = _ref_step(jcfg, snap, p)
    s, m = _port_step(cfg, snap, p)
    assert m.iterations == jm.iterations
    assert m.matched_fraction == pytest.approx(jm.matched_fraction,
                                               abs=1e-6)
    et, er = _pose_err(np.asarray(js.pose), s.pose.numpy())
    assert et < 1e-4 and er < 1e-4


@pytest.mark.parametrize("method", ["icp_point", "icp_plane"])
def test_icp_step_from_reference_state(oracle, method):
    jcfg = _jconfig(method=method,
                    icp=JICP(max_iterations=25, max_corr_dist=1.0,
                             nn_impl="xla"))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    snap, p = oracle["snaps"][2], oracle["pts"][2]
    js, jm = _ref_step(jcfg, snap, p)
    s, m = _port_step(cfg, snap, p)
    assert m.iterations == jm.iterations
    et, er = _pose_err(np.asarray(js.pose), s.pose.numpy())
    assert et < 1e-4 and er < 1e-4


def test_whole_run_matches_reference(oracle):
    """Bootstrap on the raw cloud, then every step: poses within 1e-4 on
    the steps where no LM accept flipped, ATE within 0.005 m, and the
    fields rebuilt on exactly the reference's scans."""
    cfg = config_from_dict(dataclasses.asdict(oracle["jcfg"]))
    odo = LidarOdometry(cfg, device="cpu")
    poses, log = odo.run(_tclouds(oracle["pts"]), init_pose=oracle["gt"][0])
    ref = oracle["poses"]
    for k in range(len(ref)):
        if log.records[k].iterations != oracle["records"][k].iterations:
            break
        et, er = _pose_err(ref[k], poses[k])
        assert et < 1e-4 and er < 1e-4, k
    assert k >= 2            # the bootstrap and the first registration
    gt = oracle["gt"]
    assert abs(ate_rmse(poses, gt, align=False)
               - j_ate(ref, gt, align=False)) < 0.005
    assert ate_rmse(poses, gt, align=False) < 0.08   # the reference's bar
    assert odo.field_builds == oracle["builds"] == N_SCANS - 1


def test_scrolling_deskew_occupancy_run_matches_reference():
    """Scrolling window with a small core (rebases on the arc), deskew and
    occupancy on, over the whole run: the map offset exact, the occupancy
    grid and the map's keys and counts exact, poses within 1e-4."""
    pts, gt = _arc(n_poses=4, n_azimuth=240, arc_fraction=0.15)
    jcfg = _jconfig(scrolling_window=True, map_half_extent=8.0,
                    rebase_fraction=0.4, deskew=True, use_occupancy=True,
                    occupancy_capacity=65536, occupancy_max_range=12.0)
    jposes, snaps, records = _run_reference(jcfg, pts, gt)
    offsets = [s["map_offset"] for s in snaps]
    assert any(not np.array_equal(offsets[0], o) for o in offsets[1:])

    cfg = config_from_dict(dataclasses.asdict(jcfg))
    odo = LidarOdometry(cfg, device="cpu")
    s = odo.init_state(gt[0])
    for k, c in enumerate(_tclouds(pts)):
        s, m = odo.step(s, c)
        assert m.iterations == records[k].iterations, k
        et, er = _pose_err(jposes[k], s.pose.numpy())
        assert et < 1e-4 and er < 1e-4, k
        d = host_state_to_numpy(s)
        ref = snaps[k + 1]
        np.testing.assert_array_equal(d["map_offset"], ref["map_offset"])
        for key in ("occ_keys", "occ_log_odds", "map_keys", "map_count"):
            np.testing.assert_array_equal(d[key], ref[key], err_msg=key)
