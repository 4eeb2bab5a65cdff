"""The dense engine's options against tpu_slam (CPU): the occupancy layer
(``grid_occupancy_update``), ``grid_coarsen`` and deskew
(``ingest.deskew``), each on the same numpy-seeded inputs.

Tolerances: the occupancy update is exact (log-odds, cleared rows and the
evicted count); ``grid_coarsen`` within 1e-5 of each channel's largest
magnitude (float32 block sums in another order); deskewed points within
1e-5 m at ranges up to ~12 m, interpolated poses within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.ingest import deskew as jdk
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.mapping import dense_map as jdm
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import deskew as dk
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import dense_map as dm

SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
JSPEC = JSpec.centered(leaf=0.5, half_extent=16.0)
DIMS = (24, 24, 8)
ORIGIN_CELL = (20, 20, 28)
CAP = 4096


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores: on two threads the
    port's small CPU ops run as fast as on all of them, and leave the rest
    to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _room_scan(seed=0, n_azimuth=180):
    """A VLP-16 revolution in a room with a box, in the world frame, and
    the sensor position (inside the window)."""
    world = syn.make_room(size=(10.0, 8.0, 3.0),
                          boxes=[(np.array([1.0, -0.5, 0.0]),
                                  np.array([2.0, 0.5, 1.2]))])
    T = np.eye(4)
    T[:3, 3] = [-1.0, 0.3, 1.3]
    rng = np.random.default_rng(seed)
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=n_azimuth,
                                               noise_std=0.005, rng=rng)
    wpts = (pts[valid] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return wpts, T[:3, 3].astype(np.float32)


def _layers(seed):
    """Seeded moment rows (half the cells occupied) and log-odds near the
    eviction threshold, so that one update evicts some cells."""
    rng = np.random.default_rng(seed)
    g = int(np.prod(DIMS))
    rows = np.zeros((g, 10), np.float32)
    on = rng.uniform(size=g) < 0.5
    rows[on, 0] = rng.integers(1, 5, on.sum())
    rows[on, 1:] = rng.normal(size=(on.sum(), 9))
    lo = rng.uniform(-1.3, 0.3, (g, 1)).astype(np.float32)
    return rows, lo


def _both(rows, lo, wpts, origin, weight, n_steps=32, max_range=15.0):
    oc = np.asarray(ORIGIN_CELL, np.int32)
    jg = jdm.DenseMomentGrid(rows=jnp.asarray(rows), origin_cell=jnp.asarray(oc),
                             dims=DIMS)
    jo = jdm.DenseMomentGrid(rows=jnp.asarray(lo), origin_cell=jnp.asarray(oc),
                             dims=DIMS)
    ref = jdm.grid_occupancy_update(
        jg, jo, jnp.asarray(origin), JCloud.from_points_host(wpts, capacity=CAP),
        JSPEC, n_steps=n_steps, max_range=max_range, weight=weight)
    tg = dm.DenseMomentGrid(rows=torch.tensor(rows),
                            origin_cell=torch.tensor(oc), dims=DIMS)
    to = dm.empty_occupancy_grid(DIMS, oc, device="cpu")
    to = dm.DenseMomentGrid(rows=torch.tensor(lo), origin_cell=to.origin_cell,
                            dims=DIMS)
    got = dm.grid_occupancy_update(
        tg, to, torch.tensor(origin),
        PointCloud.from_points_host(wpts, capacity=CAP, device="cpu"), SPEC,
        n_steps=n_steps, max_range=max_range,
        weight=torch.tensor(weight))
    return ref, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_update_matches_reference_exactly(seed):
    wpts, origin = _room_scan(seed)
    rows, lo = _layers(seed)
    (jg, jo, jn), (tg, to, tn) = _both(rows, lo, wpts, origin, 1.0)
    assert int(jn) == int(tn) > 0                     # something evicted
    np.testing.assert_array_equal(to.rows.numpy(), np.asarray(jo.rows))
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    # every marked cell moved: hits and misses both reached the window
    changed = to.rows.numpy() != lo
    assert changed.sum() > 100
    assert tuple(to.origin_cell.tolist()) == ORIGIN_CELL


def test_occupancy_update_duplicates_and_reject():
    """Many samples and endpoints in one cell give one miss / one hit;
    weight 0 changes nothing."""
    wpts, origin = _room_scan(3)
    rows, lo = _layers(3)
    # every point three times: the same cells, the same marks
    tripled = np.concatenate([wpts, wpts, wpts])[:CAP]
    (_, jo1, _), (_, to1, _) = _both(rows, lo, wpts, origin, 1.0)
    (_, jo3, _), (_, to3, _) = _both(rows, lo, tripled, origin, 1.0)
    np.testing.assert_array_equal(to3.rows.numpy(), to1.rows.numpy())
    np.testing.assert_array_equal(np.asarray(jo3.rows), to3.rows.numpy())
    (jg, jo, jn), (tg, to, tn) = _both(rows, lo, wpts, origin, 0.0)
    assert int(jn) == int(tn) == 0
    np.testing.assert_array_equal(to.rows.numpy(), lo)
    np.testing.assert_array_equal(tg.rows.numpy(), rows)


def test_grid_coarsen_matches_reference():
    rng = np.random.default_rng(5)
    lo = (np.asarray(SPEC.origin) + np.asarray(ORIGIN_CELL) * SPEC.leaf)
    hi = lo + np.asarray(DIMS) * SPEC.leaf
    pts = rng.uniform(lo - 0.5, hi + 0.5, (3000, 3)).astype(np.float32)
    jg = jdm.grid_insert(jdm.empty_grid(DIMS, jnp.asarray(ORIGIN_CELL)),
                         JCloud.from_points_host(pts, capacity=CAP), JSPEC)
    rows = np.array(jg.rows)
    for f in (2, 4):
        ref = jdm.grid_coarsen(
            jdm.DenseMomentGrid(rows=jnp.asarray(rows),
                                origin_cell=jnp.asarray(ORIGIN_CELL,
                                                        jnp.int32),
                                dims=DIMS), JSPEC, f)
        got = dm.grid_coarsen(
            dm.DenseMomentGrid(rows=torch.tensor(rows),
                               origin_cell=torch.tensor(ORIGIN_CELL,
                                                        dtype=torch.int32),
                               dims=DIMS), SPEC, f)
        assert got.dims == ref.dims
        np.testing.assert_array_equal(got.origin_cell.numpy(),
                                      np.asarray(ref.origin_cell))
        r = np.asarray(ref.rows)
        # counts are small integers: exact; moments within 1e-5 of each
        # channel's largest magnitude (block sums in another order)
        np.testing.assert_array_equal(got.rows[:, 0].numpy(), r[:, 0])
        scale = np.abs(r).max(axis=0)
        assert np.all(np.abs(got.rows.numpy() - r) <= 1e-5 * scale)
    with pytest.raises(ValueError):
        dm.grid_coarsen(dm.empty_grid((24, 24, 6), ORIGIN_CELL, "cpu"),
                        SPEC, 4)


def test_interpolate_pose_matches_reference():
    rng = np.random.default_rng(0)
    xi0, xi1 = rng.normal(0, 0.5, (2, 6)).astype(np.float32)
    T0 = np.asarray(jse3.exp(jnp.asarray(xi0)))
    T1 = np.asarray(jse3.exp(jnp.asarray(xi1)))
    alpha = rng.uniform(0, 1, 50).astype(np.float32)
    ref = np.asarray(jdk.interpolate_pose(jnp.asarray(T0), jnp.asarray(T1),
                                          jnp.asarray(alpha)))
    got = dk.interpolate_pose(torch.tensor(T0), torch.tensor(T1),
                              torch.tensor(alpha)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    one = dk.interpolate_pose(torch.tensor(T0), torch.tensor(T1),
                              torch.tensor(0.5, dtype=torch.float32))
    assert one.shape == (4, 4)
    np.testing.assert_allclose(one.numpy(), np.asarray(jdk.interpolate_pose(
        jnp.asarray(T0), jnp.asarray(T1), jnp.float32(0.5))), atol=1e-5)
    np.testing.assert_allclose(
        dk.interpolate_pose(torch.tensor(T0), torch.tensor(T1),
                            torch.tensor(1.0)).numpy(), T1, atol=1e-5)


def test_deskew_cloud_and_time_fractions_match_reference():
    rng = np.random.default_rng(1)
    n = 3000
    pts = rng.uniform(-12.0, 12.0, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.2
    cap = n + 96
    jc = JCloud.from_points_host(pts, capacity=cap)
    tc = PointCloud.from_points_host(pts, capacity=cap, device="cpu")
    frac_ref = np.asarray(jdk.vlp16_time_fractions(jc.points))
    frac = dk.vlp16_time_fractions(tc.points)
    valid = np.arange(cap) < n
    np.testing.assert_allclose(frac.numpy()[valid], frac_ref[valid],
                               atol=1e-6)
    assert float(frac.min()) >= 0.0 and float(frac.max()) < 1.0
    # the engine's call: the sweep ran from inv(pred) to the identity
    pred = np.asarray(jse3.exp(jnp.asarray([0.4, 0.1, 0.02, 0.0, 0.01, 0.08],
                                           jnp.float32)))
    T_start = np.asarray(jse3.inverse(jnp.asarray(pred)))
    ref = jdk.deskew_cloud(jc, jnp.asarray(frac_ref), jnp.asarray(T_start),
                           jnp.eye(4, dtype=jnp.float32))
    got = dk.deskew_cloud(tc, torch.tensor(frac_ref), torch.tensor(T_start),
                          torch.eye(4))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.points.numpy()[valid],
                               np.asarray(ref.points)[valid], atol=1e-5)
    # padded rows are left where they were
    np.testing.assert_array_equal(got.points.numpy()[~valid],
                                  tc.points.numpy()[~valid])
    moved = np.linalg.norm(got.points.numpy()[valid] - pts, axis=1)
    assert moved.max() > 0.3                      # it did undistort


def test_deskew_recovers_static_geometry():
    """The reference's own check, on the port: a sweep captured while the
    base moves, deskewed into the sweep-end frame, lies on the world's
    surfaces (median distance < 2 mm and < 0.05x the raw points')."""
    world = syn.default_office()
    T_start = syn.se2_pose(0.0, 0.0, 0.0, z=1.2)
    T_end = syn.se2_pose(0.4, 0.1, 0.08, z=1.2)
    rel = torch.tensor(np.linalg.inv(T_start) @ T_end, dtype=torch.float32)
    xi = se3.log(rel)
    n_az = 360
    dirs = syn.vlp16_directions(n_az)
    frac = np.arctan2(dirs[:, 1], dirs[:, 0]) % (2 * np.pi) / (2 * np.pi)
    pts = np.zeros((dirs.shape[0], 3), np.float32)
    valid = np.zeros(dirs.shape[0], bool)
    for chunk in range(36):
        sel = slice(chunk * 160, (chunk + 1) * 160)
        a = float(np.median(frac[sel]))
        T_a = T_start @ se3.exp(a * xi).double().numpy()
        dw = dirs[sel] @ T_a[:3, :3].T
        r = world.raycast(np.broadcast_to(T_a[:3, 3], dw.shape), dw)
        v = np.isfinite(r)
        pts[sel] = dirs[sel] * np.where(v, r, 0.0)[:, None]
        valid[sel] = v
        frac[sel] = a
    cloud = PointCloud(points=torch.tensor(pts), mask=torch.tensor(valid))
    fixed = dk.deskew_cloud(cloud, torch.tensor(frac, dtype=torch.float32),
                            torch.tensor(T_start, dtype=torch.float32),
                            torch.tensor(T_end, dtype=torch.float32))

    def surface_dist(body_pts):
        w = body_pts[valid] @ T_end[:3, :3].T + T_end[:3, 3]
        o, _, _, nrm = world._arrays()
        d = np.abs(np.einsum("nkd,kd->nk", w[:, None, :] - o[None], nrm))
        return np.median(d.min(axis=1))

    err_deskew = surface_dist(fixed.points.numpy())
    err_raw = surface_dist(pts)
    assert err_deskew < 0.05 * err_raw, (err_deskew, err_raw)
    assert err_deskew < 2e-3, err_deskew
