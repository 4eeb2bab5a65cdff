"""The dense engine with both of its options on (occupancy eviction and
deskew) against tpu_slam's engine with the same options, three scans
(CPU).

One reference run (module-scoped: its step compiles for about a minute,
so one run carries both options; its Pallas terms kernel is swapped for
ndt_terms_raster_reference, as in test_torch_odometry_dense). The scans:
a room with a box, the box gone from the second scan on, the sensor moving
0.3 m a scan. The eviction threshold is raised to -0.3 so that one miss
clears a cell: the box's cells go in the first step. The third scan is
captured while the sensor moves from the second pose to the third, which
is what deskew undoes (the first two steps predict no motion, so the
first two scans are captured standing).

Tolerances: init state exact; poses within 5e-3 (float32 costs that agree
to ~1e-6 flip an LM accept and the two solves stop at different points of
the same basin: 4.0e-3 apart in z, 5 against 12 iterations, on the
occupancy scene's third scan, both within 14 mm of the truth); the
occupancy layer's log-odds equal except in at most 2% of the cells an
update touched (rays cast from poses mm apart reach neighbouring cells);
the box's cells cleared on both sides.
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
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
from tpu_slam_torch.pipeline.state import (config_from_dict, state_from_numpy,
                                           state_to_numpy)

DIMS = (32, 32, 16)
CAP = 12288
BOX = (np.array([1.0, -0.8, 0.0]), np.array([2.2, 0.8, 1.4]))
OPTIONS = dict(use_occupancy=True, occupancy_steps=48,
               occupancy_max_range=12.0, occupancy_evict_below=-0.3,
               min_insert_fraction=0.0, deskew=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores: on two threads the
    port's small CPU ops run as fast as on all of them, and leave the rest
    to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
        pyramid_factor=2, **OPTIONS)


def _moving_scan(world, T0, T1, rng, n_azimuth=600, chunks=60):
    """A revolution captured while the sensor moves from T0 to T1 at a
    constant twist: each block of azimuths from its interpolated pose,
    points in the sensor frame of their own capture time."""
    from tpu_slam_torch.core import se3

    xi = se3.log(torch.tensor(np.linalg.inv(T0) @ T1, dtype=torch.float32))
    dirs = syn.vlp16_directions(n_azimuth)       # azimuth-major
    frac = np.arctan2(dirs[:, 1], dirs[:, 0]) % (2 * np.pi) / (2 * np.pi)
    pts = np.zeros((dirs.shape[0], 3), np.float32)
    valid = np.zeros(dirs.shape[0], bool)
    per = dirs.shape[0] // chunks
    for c in range(chunks):
        sel = slice(c * per, (c + 1) * per)
        a = float(np.median(frac[sel]))
        T_a = T0 @ se3.exp(a * xi).double().numpy()
        dw = dirs[sel] @ T_a[:3, :3].T
        r = world.raycast(np.broadcast_to(T_a[:3, 3], dw.shape), dw)
        v = np.isfinite(r) & (r >= 0.4)
        r = r + rng.normal(0.0, 0.005, r.shape)
        pts[sel] = dirs[sel] * np.where(v, r, 0.0)[:, None]
        valid[sel] = v
    return pts[valid]


def _snapshot(s):
    d = {"pose": np.array(s.pose), "last_delta": np.array(s.last_delta),
         "scan_index": np.array(s.scan_index),
         "last_metrics": np.array(s.last_metrics)}
    for name in ("grid", "wide", "occ"):
        w = getattr(s, name)
        d[name + "_rows"] = None if w is None else np.array(w.rows)
        d[name + "_origin_cell"] = (None if w is None
                                    else np.array(w.origin_cell))
    return d


@pytest.fixture(scope="module")
def oracle():
    with_box = syn.make_room(size=(12.0, 9.0, 3.0), boxes=[BOX])
    without = syn.make_room(size=(12.0, 9.0, 3.0))
    rng = np.random.default_rng(0)
    pts_list, gt = [], []
    for k in range(3):
        T = syn.se2_pose(-2.0 + 0.3 * k, 0.1 * k, 0.05 * k, z=1.3)
        world = with_box if k == 0 else without
        if k == 2:
            pts_list.append(_moving_scan(world, gt[1], T, rng))
        else:
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
        states = [_snapshot(s)]            # snapshot: step donates s
        for c in jclouds[1:]:
            s = odo.step(s, c)
            states.append(_snapshot(s))
    return dict(pts=pts_list, gt=np.stack(gt), cfg=jcfg, states=states)


def _engine(oracle):
    cfg = config_from_dict(dataclasses.asdict(oracle["cfg"]))
    return DenseLidarOdometry(cfg, device="cpu")


def _clouds(oracle):
    return [PointCloud.from_points_host(p, capacity=CAP, device="cpu")
            for p in oracle["pts"]]


def _box_cells(rows, origin_cell, spec):
    wx, wy, wz = DIMS
    idx = np.arange(rows.shape[0])
    cc = np.stack([idx // (wy * wz), (idx // wz) % wy, idx % wz], 1)
    centers = (np.asarray(spec.origin) + (cc + origin_cell) * spec.leaf
               + 0.5 * spec.leaf)
    inside = ((centers > BOX[0] - 0.2) & (centers < BOX[1] + 0.2)).all(1)
    return int(np.sum((rows[:, 0] > 0) & inside))


def test_init_state_matches_reference(oracle):
    odo = _engine(oracle)
    s = state_to_numpy(odo.init_state(_clouds(oracle)[0], oracle["gt"][0]))
    ref = oracle["states"][0]
    assert (s["occ_rows"] is None) == (ref["occ_rows"] is None)
    for k in ("grid_origin_cell", "wide_origin_cell", "occ_origin_cell",
              "occ_rows", "scan_index", "pose"):
        if ref[k] is not None:
            np.testing.assert_array_equal(s[k], ref[k])


def test_one_step_from_carried_state(oracle):
    """The port started from the reference's state after scan 1 (its
    occupancy layer included) and stepped on scan 2."""
    odo = _engine(oracle)
    ref1, ref2 = oracle["states"][1], oracle["states"][2]
    out = state_to_numpy(odo.step(state_from_numpy(ref1, DIMS, "cpu"),
                                  _clouds(oracle)[2]))
    np.testing.assert_allclose(out["pose"], ref2["pose"], atol=5e-3)
    for k in ("grid_origin_cell", "wide_origin_cell", "scan_index"):
        np.testing.assert_array_equal(out[k], ref2[k])
    np.testing.assert_array_equal(out["occ_origin_cell"],
                                  ref2["occ_origin_cell"])
    touched = (ref2["occ_rows"] != ref1["occ_rows"]).sum()
    differ = (out["occ_rows"] != ref2["occ_rows"]).sum()
    assert touched > 500 and differ <= 0.02 * touched, (differ, touched)


def test_three_scan_run_matches_reference(oracle):
    odo = _engine(oracle)
    clouds = _clouds(oracle)
    state = odo.init_state(clouds[0], oracle["gt"][0])
    states = [state]
    for c in clouds[1:]:
        state = odo.step(state, c)
        states.append(state)
    ref = np.stack([s["pose"] for s in oracle["states"]])
    poses = np.stack([s.pose.numpy() for s in states])
    np.testing.assert_allclose(poses, ref, atol=5e-3)
    for p in (poses, ref):
        assert np.abs(p[:, :3, 3] - oracle["gt"][:, :3, 3]).max() < 0.05
    assert ndt_terms.launches == 0                    # CPU: plain version
    spec = odo.map_spec
    before = _box_cells(oracle["states"][0]["grid_rows"],
                        oracle["states"][0]["grid_origin_cell"], spec)
    last = state_to_numpy(state)
    got = _box_cells(last["grid_rows"], last["grid_origin_cell"], spec)
    want = _box_cells(oracle["states"][2]["grid_rows"],
                      oracle["states"][2]["grid_origin_cell"], spec)
    assert before > 10
    assert got <= 0.3 * before and want <= 0.3 * before
    assert int(odo.n_evicted) > 0
    # the moving third scan: without deskew the same engine lands farther
    # from the truth than both deskewed solves
    plain = DenseLidarOdometry(dataclasses.replace(odo.config, deskew=False),
                               device="cpu")
    p_raw = plain.run(clouds, init_pose=oracle["gt"][0], sync_every=0)[0]
    err = [np.linalg.norm(p[2, :3, 3] - oracle["gt"][2, :3, 3])
           for p in (poses, ref, p_raw)]
    assert err[2] > max(err[0], err[1]), err
