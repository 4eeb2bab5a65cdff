"""The port's JitLidarOdometry against tpu_slam's (CPU), on the office arc
of the reference's own tests, and the reference's own bars on the port.

Both engines run ``terms_impl="xla"`` (the sparse path; the reference's
CPU default, pinned on both sides). Held to, over a short run: poses
within 1e-4 m / 1e-4 rad on the first registration, within 5 mm on the
later ones (their LM runs to its iteration cap on steps that change the
cost below its float32 resolution, so the order of the sums decides each
accept); the accepted and inserted flags exact; after the first
registration, iterations, the matched fraction (within 1e-5) and the
map's keys, counts and stamps exact; and a garbage scan far outside the
map rejected and not inserted, the map left bit-identical on both sides.
"""

import math

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.pipeline.config import OdometryConfig as JConfig
from tpu_slam.pipeline.odometry_jit import JitLidarOdometry as JJit
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.odometry_jit import JitLidarOdometry
from tpu_slam_torch.pipeline.state import config_from_dict

JCFG = JConfig(scan_capacity=4096, downsample_leaf=0.3, map_leaf=0.5,
               map_half_extent=16.0, map_capacity=16384,
               ndt=JParams(max_iterations=25, terms_impl="xla"))
MAP_FIELDS = ("keys", "count", "stamp")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arc(n_poses, n_azimuth=360):
    """The reference's _sequence (tests/test_pipeline.py)."""
    world = syn.default_office()
    rng = np.random.default_rng(0)
    gt, pts = [], []
    for k in range(n_poses):
        a = 2 * math.pi * 0.25 * k / max(n_poses - 1, 1)
        T = syn.se2_pose(2.5 * math.cos(a), 2.5 * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.01, rng=rng)
        gt.append(T)
        pts.append(p[valid])
    return pts, np.stack(gt)


def _junk():
    rng = np.random.default_rng(0)
    return rng.uniform(200, 250, (4096, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def oracle():
    """The reference over 4 arc scans, then a garbage scan."""
    pts, gt = _arc(4)
    jodo = JJit(JCFG)
    s = jodo.init_state(JCloud.from_points(jnp.asarray(pts[0]), 16384),
                        jnp.asarray(gt[0], jnp.float32))
    states = []
    for p in pts[1:] + [_junk()]:
        s = jodo.step(s, JCloud.from_points(jnp.asarray(p), 16384))
        states.append({"pose": np.array(s.pose),
                       "metrics": np.array(s.last_metrics),
                       **{f: np.array(getattr(s.vmap, f))
                          for f in MAP_FIELDS}})
    return pts, gt, states


def _port_run(pts, gt):
    cfg = config_from_dict(dataclasses.asdict(JCFG))
    odo = JitLidarOdometry(cfg, device="cpu")
    s = odo.init_state(PointCloud.from_points_host(pts[0], 16384,
                                                   device="cpu"), gt[0])
    out = []
    for p in pts[1:]:
        s = odo.step(s, PointCloud.from_points_host(p, 16384, device="cpu"))
        out.append(s)
    return out


def test_jit_engine_matches_reference(oracle):
    pts, gt, ref = oracle
    got = _port_run(pts + [_junk()], gt)
    for k, (s, r) in enumerate(zip(got, ref)):
        m = s.last_metrics.numpy()
        # the first registration within 1e-4; the later ones run their LM
        # to its iteration cap on steps below the cost's float32
        # resolution, where the order of the sums decides each accept:
        # within 5 mm
        tol = 1e-4 if k == 0 else 5e-3
        d = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(r["pose"])
                                            @ s.pose.numpy())))
        assert np.linalg.norm(d[:3]) < tol, k
        assert np.linalg.norm(d[3:]) < tol, k
        assert m[1] == pytest.approx(r["metrics"][1], abs=1e-3)
        np.testing.assert_array_equal(m[2:], r["metrics"][2:])
        if k == 0:                 # the first registration: iterations too
            assert m[0] == r["metrics"][0]
            assert m[1] == pytest.approx(r["metrics"][1], abs=1e-5)
            for f in MAP_FIELDS:
                np.testing.assert_array_equal(getattr(s.vmap, f).numpy(),
                                              r[f], err_msg=f)
    # the garbage scan: rejected, not inserted, the map unchanged
    junk, before = got[-1], got[-2]
    assert junk.last_metrics[2] == 0.0 and junk.last_metrics[3] == 0.0
    for f in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(junk.vmap, f).numpy(),
                                      getattr(before.vmap, f).numpy())
    np.testing.assert_array_equal(ref[-1]["keys"], ref[-2]["keys"])
    assert np.linalg.norm(junk.pose[:3, 3].numpy()
                          - before.pose[:3, 3].numpy()) < 1.0


def test_jit_engine_reference_bars():
    """The reference's own bars (test_odometry_jit.py) on the port: ATE
    under 0.08 m over 8 arc scans, the metrics on the device."""
    pts, gt = _arc(8)
    got = _port_run(pts, gt)
    poses = np.stack([gt[0].astype(np.float32)]
                     + [s.pose.numpy() for s in got])
    assert ate_rmse(poses, gt, align=False) < 0.08
    m = got[-1].last_metrics.numpy()
    assert m[1] > 0.5 and m[2] == 1.0
    assert int(got[-1].scan_index) == 8
