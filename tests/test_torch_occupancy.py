"""The port's occupancy grid (mapping/occupancy.py) against tpu_slam's
(CPU), on the same seeded rays, and the reference's own bars on the port.

Tolerances: keys, log-odds increments, merged log-odds and evictions exact
(each voxel takes one of two constants a scan, and an update adds at most
two values per key, so no float sum depends on its order); the moments of
the evicted map within 1e-5 of each array's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.mapping import occupancy as jocc
from tpu_slam.mapping import voxel_map as jvm
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import occupancy as occ
from tpu_slam_torch.mapping import voxel_map as vm

SPEC = VoxelGridSpec.centered(leaf=0.25, half_extent=8.0)
JSPEC = JSpec.centered(leaf=0.25, half_extent=8.0)
ORIGIN = np.array([-2.0, 0.3, 1.3], np.float32)


def _scan(seed, n_azimuth=120, box=True):
    """A VLP-16 revolution in a room (with or without a box in it)."""
    walls = dict(size=(12.0, 9.0, 3.0))
    if box:
        walls["boxes"] = [(np.array([1.5, -0.8, 0.0]),
                           np.array([2.6, 0.8, 1.4]))]
    T = np.eye(4)
    T[:3, 3] = ORIGIN
    pts, valid = syn.simulate_vlp16_revolution(
        syn.make_room(**walls), T, n_azimuth=n_azimuth, noise_std=0.005,
        rng=np.random.default_rng(seed))
    pts = pts[valid]
    return (JCloud.from_points(jnp.asarray(pts), capacity=2048),
            PointCloud.from_points_host(pts, capacity=2048, device="cpu"))


def _assert_grid(tg, jg):
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    np.testing.assert_array_equal(tg.log_odds.numpy(),
                                  np.asarray(jg.log_odds))


@pytest.mark.parametrize("max_range", [30.0, 3.0])
def test_ray_evidence_matches_reference(max_range):
    """All rays in range, and a range gate that cuts most endpoints."""
    jc, tc = _scan(0)
    jk, jd = jocc.ray_evidence(jnp.asarray(ORIGIN), jc, JSPEC, n_steps=48,
                               max_range=max_range)
    tk, td = occ.ray_evidence(torch.as_tensor(ORIGIN), tc, SPEC, n_steps=48,
                              max_range=max_range)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (td > 0).sum() > 50 and (td < 0).sum() > 500


@pytest.mark.parametrize("capacity", [65536, 1500])
def test_occupancy_update_matches_reference(capacity):
    """Three scans of evidence into a grid that holds them all, and into
    one that keeps only the strongest 1,500 voxels."""
    jg = jocc.empty_occupancy(capacity)
    tg = occ.empty_occupancy(capacity, device="cpu")
    for seed, box in [(1, True), (2, True), (3, False)]:
        jc, tc = _scan(seed, box=box)
        jk, jd = jocc.ray_evidence(jnp.asarray(ORIGIN), jc, JSPEC,
                                   n_steps=48)
        tk, td = occ.ray_evidence(torch.as_tensor(ORIGIN), tc, SPEC,
                                  n_steps=48)
        jg = jocc.occupancy_update(jg, jk, jd)
        tg = occ.occupancy_update(tg, tk, td)
        _assert_grid(tg, jg)
    assert int((tg.log_odds != 0).sum()) > 1000 or capacity == 1500


def test_shift_and_queries_match_reference():
    jc, tc = _scan(4)
    jg = jocc.occupancy_update(jocc.empty_occupancy(8192), *jocc.ray_evidence(
        jnp.asarray(ORIGIN), jc, JSPEC, n_steps=48))
    tg = occ.occupancy_update(
        occ.empty_occupancy(8192, device="cpu"),
        *occ.ray_evidence(torch.as_tensor(ORIGIN), tc, SPEC, n_steps=48))
    shift = np.array([20, -3, 7], np.int32)          # leaves the grid in x
    _assert_grid(occ.shift_occupancy_cells(tg, SPEC, torch.as_tensor(shift)),
                 jocc.shift_occupancy_cells(jg, JSPEC, jnp.asarray(shift)))
    q = np.random.default_rng(5).uniform(-7, 7, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        occ.query_occupancy(tg, torch.as_tensor(q), SPEC).numpy(),
        np.asarray(jocc.query_occupancy(jg, jnp.asarray(q), JSPEC)))
    np.testing.assert_allclose(occ.occupancy_probability(tg).numpy(),
                               np.asarray(jocc.occupancy_probability(jg)),
                               rtol=1e-6)


def test_occupancy_maintain_matches_reference():
    """The box is in the map, then rays see through it for eight scans:
    the grid, the evicted map and the evicted counts equal the
    reference's."""
    jc0, tc0 = _scan(6)
    jmap = jvm.insert_cloud(jvm.empty_map(8192), jc0, JSPEC, stamp=0.0)
    tmap = vm.insert_cloud(vm.empty_map(8192, device="cpu"), tc0, SPEC,
                           stamp=0.0)
    jg = jocc.empty_occupancy(32768)
    tg = occ.empty_occupancy(32768, device="cpu")
    total = 0
    for seed in range(7, 15):
        jc, tc = _scan(seed, box=False)
        jg, jmap, jn = jocc.occupancy_maintain(
            jg, jmap, jnp.asarray(ORIGIN), jc, JSPEC, n_steps=64,
            max_range=15.0, evict_below=-1.0)
        tg, tmap, tn = occ.occupancy_maintain(
            tg, tmap, torch.as_tensor(ORIGIN), tc, SPEC, n_steps=64,
            max_range=15.0, evict_below=-1.0)
        assert int(tn) == int(jn)
        total += int(tn)
        _assert_grid(tg, jg)
        np.testing.assert_array_equal(tmap.keys.numpy(),
                                      np.asarray(jmap.keys))
        np.testing.assert_array_equal(tmap.count.numpy(),
                                      np.asarray(jmap.count))
        scale = float(np.abs(np.asarray(jmap.sum_outer)).max())
        np.testing.assert_allclose(tmap.sum_outer.numpy(),
                                   np.asarray(jmap.sum_outer), rtol=0,
                                   atol=1e-5 * scale)
    assert total > 10


def test_occupancy_hits_and_freespace():
    """The reference's own bars (``test_occupancy_hits_and_freespace``)."""
    origin = torch.tensor([0.0, 0.0, 1.0])
    ys = np.linspace(-2, 2, 50)
    pts = np.stack([np.full(50, 4.0), ys, np.full(50, 1.0)], 1).astype(
        np.float32)
    cloud = PointCloud.from_points_host(pts, capacity=64, device="cpu")
    grid = occ.occupancy_update(occ.empty_occupancy(8192, device="cpu"),
                                *occ.ray_evidence(origin, cloud, SPEC,
                                                  n_steps=64))
    assert float(occ.query_occupancy(grid, torch.as_tensor(pts),
                                     SPEC).min()) > 0
    mid = np.stack([np.full(50, 2.0), 0.5 * ys, np.full(50, 1.0)],
                   1).astype(np.float32)
    assert float(occ.query_occupancy(grid, torch.as_tensor(mid),
                                     SPEC).max()) < 0
    unk = torch.tensor([[0.0, 0.0, 6.0]])
    assert float(occ.query_occupancy(grid, unk, SPEC)[0]) == 0.0
    assert float(occ.occupancy_probability(grid).max()) <= 1.0


def test_occupancy_accumulates_and_clamps():
    """The reference's own bar (``test_occupancy_accumulates_and_
    clamps``): twenty scans of one hit clamp at max_log."""
    origin = torch.tensor([0.0, 0.0, 1.0])
    pts = torch.tensor([[3.0, 0.0, 1.0]])
    cloud = PointCloud.from_points_host(pts.numpy(), capacity=8,
                                        device="cpu")
    grid = occ.empty_occupancy(1024, device="cpu")
    for _ in range(20):
        grid = occ.occupancy_update(grid, *occ.ray_evidence(
            origin, cloud, SPEC, n_steps=64))
    lo = occ.query_occupancy(grid, pts, SPEC)
    assert float(lo[0]) <= 6.0 + 1e-6
    assert float(lo[0]) == pytest.approx(6.0)
