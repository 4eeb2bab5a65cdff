"""The port's DenseLidarOdometry against tpu_slam's, on the same scans (CPU).

The reference engine runs once per module (its first step compiles for
about a minute on a CPU): its Pallas terms kernel is swapped for
ndt_terms_raster_reference, the XLA twin its own tests compare the kernel
with. Its state is snapshot as numpy after init and after each step, so
the port can be started from the reference's state and compared over a
single step, and over a whole three-scan run from the same first scan.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.pipeline.config import OdometryConfig as JConfig
from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry as JOdometry
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.ndt_terms import ndt_terms
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
from tpu_slam_torch.pipeline.state import (config_from_dict, state_from_numpy,
                                           state_to_numpy)

DIMS = (32, 32, 16)
CAP = 12288


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    return j_terms.ndt_terms_raster_reference(raster, planes, T, gamma,
                                              max_corr_dist, dims, q_cap)


def _jconfig():
    return JConfig(
        scan_capacity=4096, downsample_leaf=0.2, map_leaf=0.4,
        map_half_extent=16.0, scan_max_range=12.0, insert_downsampled=True,
        ndt=JParams(max_iterations=10, coarse_iterations=2, tolerance=3e-4,
                    min_voxel_count=3.0, window_dims=DIMS,
                    terms_impl="pallas_interpret"),
        pyramid_factor=2)


def _jstate_numpy(s):
    return {"pose": np.array(s.pose), "last_delta": np.array(s.last_delta),
            "grid_rows": np.array(s.grid.rows),
            "grid_origin_cell": np.array(s.grid.origin_cell),
            "wide_rows": np.array(s.wide.rows),
            "wide_origin_cell": np.array(s.wide.origin_cell),
            "scan_index": np.array(s.scan_index),
            "last_metrics": np.array(s.last_metrics)}


@pytest.fixture(scope="module")
def oracle():
    world = syn.default_office()
    rng = np.random.default_rng(0)
    pts_list, gt = [], []
    for k in range(3):
        T = syn.se2_pose(0.3 * k - 0.6, 0.12 * k - 0.3, 0.07 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=600, noise_std=0.005, rng=rng)
        pts_list.append(pts[valid])
        gt.append(T)
    jcfg = _jconfig()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_terms, "ndt_terms_raster", _reference_terms)
        odo = JOdometry(jcfg)
        jclouds = [JCloud.from_points_host(p, capacity=CAP) for p in pts_list]
        s = odo.init_state(jclouds[0], jnp.asarray(gt[0], jnp.float32))
        states = [_jstate_numpy(s)]        # snapshot: step donates s
        for c in jclouds[1:]:
            s = odo.step(s, c)
            states.append(_jstate_numpy(s))
    return dict(pts=pts_list, gt=np.stack(gt), cfg=jcfg, states=states)


def _rows_close(got, ref, per_point):
    """Moment rows agree: equal total count, and every row within
    ``per_point`` x its count, except rows that gained or lost a point
    lying within an ulp of a cell face — the reference's jitted arithmetic
    (XLA fuses (p - origin) / leaf differently from an eager division)
    rounds such a point into the neighbouring cell. At most 0.5% of the
    occupied rows may differ that way."""
    assert abs(float(got[:, 0].sum()) - float(ref[:, 0].sum())) < 0.5
    cnt = np.maximum(ref[:, :1], 1.0)
    bad = np.any(np.abs(got - ref) > per_point * cnt + 1e-5, axis=1)
    assert bad.sum() <= max(4, 0.005 * (ref[:, 0] > 0).sum()), bad.sum()


def _world_moments(rows, origin_cell, leaf, grid_origin):
    """Window totals in the world frame: count, sum p, sum p p^T — the
    same for any assignment of points to cells."""
    wx, wy, wz = DIMS
    ci = np.arange(wx * wy * wz)
    cell = np.stack([ci // (wy * wz), (ci // wz) % wy, ci % wz], 1)
    corner = (cell + origin_cell) * leaf + np.asarray(grid_origin)
    n, s = rows[:, 0].astype(np.float64), rows[:, 1:4].astype(np.float64)
    iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    o = np.zeros((len(rows), 3, 3))
    for k, (i, j) in enumerate(iu):
        o[:, i, j] = o[:, j, i] = rows[:, 4 + k]
    sw = s + n[:, None] * corner
    ow = (o + corner[:, :, None] * s[:, None, :]
          + s[:, :, None] * corner[:, None, :]
          + n[:, None, None] * corner[:, :, None] * corner[:, None, :])
    return n.sum(), sw.sum(0), ow.sum(0)


def _engine(oracle):
    cfg = config_from_dict(dataclasses.asdict(oracle["cfg"]))
    return DenseLidarOdometry(cfg, device="cpu")


def _clouds(oracle):
    return [PointCloud.from_points_host(p, capacity=CAP, device="cpu")
            for p in oracle["pts"]]


def test_config_carried_across(oracle):
    cfg = config_from_dict(dataclasses.asdict(oracle["cfg"]))
    assert cfg.ndt.window_dims == DIMS and cfg.pyramid_factor == 2
    ref = dataclasses.asdict(oracle["cfg"])
    for k, v in dataclasses.asdict(cfg).items():
        if k not in ("ndt", "icp"):
            assert ref[k] == v, k
    for k, v in dataclasses.asdict(cfg.ndt).items():
        assert ref["ndt"][k] == (list(v) if isinstance(v, tuple) else v) \
            or tuple(ref["ndt"][k]) == v, k


def test_init_state_matches_reference(oracle):
    odo = _engine(oracle)
    s = state_to_numpy(odo.init_state(_clouds(oracle)[0], oracle["gt"][0]))
    ref = oracle["states"][0]
    for k in ("grid_origin_cell", "wide_origin_cell", "scan_index"):
        np.testing.assert_array_equal(s[k], ref[k])
    np.testing.assert_allclose(s["pose"], ref["pose"], atol=0)
    # same points, same cells; per-cell float32 sums in input order
    for k in ("grid_rows", "wide_rows"):
        _rows_close(s[k], ref[k], 1e-5)


def test_one_step_from_carried_state(oracle):
    """Start the port from the reference's state after scan 1 and compare
    the step on scan 2: pose, both windows and the metrics."""
    odo = _engine(oracle)
    ref1, ref2 = oracle["states"][1], oracle["states"][2]
    state = state_from_numpy(ref1, DIMS, "cpu")
    out = state_to_numpy(odo.step(state, _clouds(oracle)[2]))
    # The LM solves stop once a step is below tolerance (3e-4). float32
    # costs that agree to ~1e-6 can still flip an accept/reject between
    # the two sides, after which each takes its own path to the same
    # optimum (8 vs 5 iterations measured on this scan), so the poses agree
    # to a few stopping steps (2e-3) and the iteration counts are not
    # compared; both land within 5 mm of the true pose.
    np.testing.assert_allclose(out["pose"], ref2["pose"], atol=2e-3)
    np.testing.assert_allclose(out["last_delta"], ref2["last_delta"],
                               atol=2e-3)
    for pose in (out["pose"], ref2["pose"]):
        assert np.linalg.norm(pose[:3, 3] - oracle["gt"][2][:3, 3]) < 5e-3
    for k in ("grid_origin_cell", "wide_origin_cell", "scan_index"):
        np.testing.assert_array_equal(out[k], ref2[k])
    m, mr = out["last_metrics"], ref2["last_metrics"]
    np.testing.assert_array_equal(m[2:4], mr[2:4])    # accepted, inserted
    assert 0 < m[0] <= 2 + 10                         # coarse + fine budget
    np.testing.assert_allclose(m[[1, 4]], mr[[1, 4]], atol=1e-2)
    # the scan is inserted at poses 2e-3 apart, so points near a cell face
    # land in different cells on the two sides; the window's world-frame
    # totals do not depend on that: same count, sums within 2e-3 m a point
    for k, spec in (("grid", odo.map_spec), ("wide", odo.coarse_spec)):
        n, sw, ow = _world_moments(out[k + "_rows"], out[k + "_origin_cell"],
                                   spec.leaf, spec.origin)
        nr, swr, owr = _world_moments(ref2[k + "_rows"],
                                      ref2[k + "_origin_cell"], spec.leaf,
                                      spec.origin)
        assert n == nr
        assert np.abs(sw - swr).max() <= 2e-3 * n
        assert np.abs(ow - owr).max() <= 2e-3 * np.abs(owr).max()


def test_three_scan_run_matches_reference(oracle):
    odo = _engine(oracle)
    poses, log = odo.run(_clouds(oracle), init_pose=oracle["gt"][0])
    ref = np.stack([s["pose"] for s in oracle["states"]])
    # per scan within a few LM stopping steps of the reference (see
    # test_one_step_from_carried_state), and the same accuracy bar
    np.testing.assert_allclose(poses, ref, atol=3e-3)
    ate, ate_ref = (ate_rmse(poses, oracle["gt"], align=False),
                    ate_rmse(ref, oracle["gt"], align=False))
    assert ate < 0.01 and ate_ref < 0.01
    assert len(log.records) == 2
    fr = [r.matched_fraction for r in log.records]
    np.testing.assert_allclose(
        fr, [s["last_metrics"][1] for s in oracle["states"][1:]], atol=2e-2)
    assert ndt_terms.launches == 0                    # CPU: plain version


def test_engine_refuses_what_is_not_ported():
    cfg = config_from_dict(dataclasses.asdict(_jconfig()))
    with pytest.raises(NotImplementedError):
        DenseLidarOdometry(dataclasses.replace(cfg, use_occupancy=True),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        DenseLidarOdometry(dataclasses.replace(cfg, deskew=True),
                           device="cpu")
    odo = DenseLidarOdometry(cfg, device="cpu")
    assert odo.device == torch.device("cpu")
