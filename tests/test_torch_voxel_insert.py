"""The port's voxel-map insert, merge, eviction and derived quantities
against tpu_slam's (CPU), on the same seeded clouds.

Tolerances: keys, counts, stamps, slots and hits exact; voxel moments
within 1e-5 of each array's largest magnitude (float32 segment sums,
possibly in another order); means and covariances within 1e-5 of theirs.
Normals come from ``eigh`` on both sides, so they are defined only up to
sign (and, for a repeated eigenvalue, a rotation): |n . n_ref| > 1 - 1e-4
where the reference's planarity test passes by a margin, and the valid
flags are equal except within 1e-6 of the threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.mapping import voxel_map as jvm
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam_torch.mapping import voxel_map as vm

SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
JSPEC = JSpec.centered(leaf=0.5, half_extent=16.0)
MOMENT_RTOL = 1e-5


def _clouds(pts, capacity):
    return (JCloud.from_points(jnp.asarray(pts), capacity=capacity),
            PointCloud.from_points_host(pts, capacity=capacity,
                                        device="cpu"))


def _plane(rng, n, z=0.0, extent=5.0, noise=0.01):
    return np.stack([rng.uniform(-extent, extent, n),
                     rng.uniform(-extent, extent, n),
                     z + rng.normal(0, noise, n)], axis=1).astype(np.float32)


def _room(rng, n):
    """Floor and two walls: planar voxels with a margin, and corners."""
    k = n // 3
    floor = _plane(rng, k, z=-1.0)
    wall_x = _plane(rng, k, z=0.0)[:, [2, 0, 1]] + [3.0, 0.0, 0.0]
    wall_y = _plane(rng, n - 2 * k, z=0.0)[:, [0, 2, 1]] + [0.0, -3.0, 0.0]
    return np.concatenate([floor, wall_x, wall_y]).astype(np.float32)


def _assert_moments(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=MOMENT_RTOL * scale)


def _assert_map(tmap, jmap):
    """Keys, counts and stamps exact; moments within the tolerance."""
    np.testing.assert_array_equal(tmap.keys.numpy(), np.asarray(jmap.keys))
    np.testing.assert_array_equal(tmap.count.numpy(), np.asarray(jmap.count))
    np.testing.assert_array_equal(tmap.stamp.numpy(), np.asarray(jmap.stamp))
    _assert_moments(tmap.sum_pts, jmap.sum_pts)
    _assert_moments(tmap.sum_outer, jmap.sum_outer)


def _maps(jmap):
    return vm.voxel_map_from_numpy(
        np.asarray(jmap.keys), np.asarray(jmap.count),
        np.asarray(jmap.sum_pts), np.asarray(jmap.sum_outer),
        np.asarray(jmap.stamp), device="cpu")


@pytest.fixture(scope="module")
def built():
    """A map of two inserts (full merge), as both packages hold it."""
    rng = np.random.default_rng(0)
    jmap = jvm.empty_map(4096)
    tmap = vm.empty_map(4096, device="cpu")
    for k, pts in enumerate([_room(rng, 3000), _room(rng, 2500) + 0.07]):
        jc, tc = _clouds(pts, 4096)
        jmap = jvm.insert_cloud(jmap, jc, JSPEC, stamp=float(k),
                                incremental=False)
        tmap = vm.insert_cloud(tmap, tc, SPEC, stamp=float(k),
                               incremental=False)
    return jmap, tmap


def test_scan_to_voxel_stats_matches_reference():
    rng = np.random.default_rng(1)
    pts = _room(rng, 3000)
    pts[::97] = [40.0, 0.0, 0.0]             # outside the grid: dropped
    jc, tc = _clouds(pts, 4096)              # 1,096 padding rows
    jk, jn, js, jo = jvm.scan_to_voxel_stats(jc, JSPEC)
    tk, tn, ts, to = vm.scan_to_voxel_stats(tc, SPEC)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_moments(ts, js)
    _assert_moments(to, jo)
    assert (tk != INVALID_KEY).sum() > 100


def test_full_merge_matches_reference(built):
    _assert_map(built[1], built[0])


def test_full_merge_over_capacity_keeps_newest_with_tied_stamps():
    """Capacity 96 against ~400 voxels a scan: the newest stamps survive;
    equal stamps fall in sorted-key order, as the reference's stable
    argsort lets them."""
    rng = np.random.default_rng(2)
    jmap, tmap = jvm.empty_map(96), vm.empty_map(96, device="cpu")
    for stamp, z in [(0.0, 0.0), (1.0, 2.0), (1.0, -2.0)]:
        jc, tc = _clouds(_plane(rng, 600, z=z), 2048)
        jmap = jvm.insert_cloud(jmap, jc, JSPEC, stamp=stamp,
                                incremental=False)
        tmap = vm.insert_cloud(tmap, tc, SPEC, stamp=stamp,
                               incremental=False)
        _assert_map(tmap, jmap)
    assert int(tmap.n_occupied()) == 96
    assert set(tmap.stamp.tolist()) == {1.0}


@pytest.mark.parametrize("branch", ["merged", "fallback"])
def test_incremental_merge_matches_reference(built, branch):
    """Both branches of the reference's lax.cond: a scan of few new voxels
    (the gather merge), and one of more new keys than ``new_cap``."""
    jmap, tmap = built
    rng = np.random.default_rng(3)
    if branch == "merged":
        pts = np.concatenate([_room(rng, 1500) + 0.03,
                              _plane(rng, 300, z=4.0)])
        new_cap = 8192
    else:
        pts = np.concatenate([_room(rng, 1500), _plane(rng, 1500, z=6.0)])
        new_cap = 64
    jc, tc = _clouds(pts, 4096)
    jstats = jvm.scan_to_voxel_stats(jc, JSPEC)
    tstats = vm.scan_to_voxel_stats(tc, SPEC)
    jm = jvm.insert_scan_stats_incremental(
        jvm.VoxelMap(*[jnp.array(a) for a in (jmap.keys, jmap.count,
                                             jmap.sum_pts, jmap.sum_outer,
                                             jmap.stamp)]),
        *jstats, jnp.float32(2.0), new_cap=new_cap)
    tm, overflowed = vm.insert_scan_stats_incremental(
        tmap, *tstats, 2.0, new_cap=new_cap)
    assert overflowed == (branch == "fallback")
    _assert_map(tm, jm)


def test_incremental_overflow_fallback_equals_full_merge():
    """The reference's own case (``test_insert_incremental_overflow_
    fallback``): over capacity, the incremental insert equals the full
    merge, and both equal the reference's."""
    rng = np.random.default_rng(8)
    jmap = jvm.empty_map(96)
    t_inc = vm.empty_map(96, device="cpu")
    t_full = vm.empty_map(96, device="cpu")
    before = vm.insert_cloud.fallbacks
    for k, z in enumerate([0.0, 2.0]):
        jc, tc = _clouds(_plane(rng, 600, z=z), 2048)
        jmap = jvm.insert_cloud(jmap, jc, JSPEC, stamp=float(k),
                                incremental=True)
        t_inc = vm.insert_cloud(t_inc, tc, SPEC, stamp=float(k),
                                incremental=True)
        t_full = vm.insert_cloud(t_full, tc, SPEC, stamp=float(k),
                                 incremental=False)
    assert vm.insert_cloud.fallbacks - before == 2
    np.testing.assert_array_equal(t_inc.keys.numpy(), t_full.keys.numpy())
    np.testing.assert_array_equal(t_inc.count.numpy(), t_full.count.numpy())
    _assert_map(t_inc, jmap)


def test_shift_and_evict_match_reference(built):
    jmap, tmap = built
    # cells leave the grid on both sides of x and the low side of z
    shift = np.array([34, -3, 30], np.int32)
    _assert_map(vm.shift_map_cells(tmap, SPEC, torch.as_tensor(shift)),
                jvm.shift_map_cells(jmap, JSPEC, jnp.asarray(shift)))
    drop = np.zeros(tmap.capacity, bool)
    drop[::3] = True
    _assert_map(vm.evict_where(tmap, torch.as_tensor(drop)),
                jvm.evict_where(jmap, jnp.asarray(drop)))


def test_means_covariances_lookup_match_reference(built):
    jmap, tmap = built
    occ = tmap.occupied_mask().numpy()
    np.testing.assert_allclose(vm.voxel_means(tmap, SPEC).numpy()[occ],
                               np.asarray(jvm.voxel_means(jmap, JSPEC))[occ],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(vm.voxel_covariances(tmap).numpy(),
                               np.asarray(jvm.voxel_covariances(jmap)),
                               rtol=0, atol=1e-5)
    keys = tmap.keys.numpy()[:200].copy()
    keys[::2] += 1                         # mostly absent neighbours
    keys[-1] = INVALID_KEY
    np.testing.assert_array_equal(
        vm.lookup_voxels(tmap, torch.as_tensor(keys)).numpy(),
        np.asarray(jvm.lookup_voxels(jmap, jnp.asarray(keys))))
    np.testing.assert_array_equal(
        vm.build_dense_lookup(tmap, SPEC).numpy(),
        np.asarray(jvm.build_dense_lookup(jmap, JSPEC)))


@pytest.mark.parametrize("use_lookup", [False, True])
def test_neighborhood_moments_match_reference(built, use_lookup):
    jmap, tmap = built
    jl = jvm.build_dense_lookup(jmap, JSPEC) if use_lookup else None
    tl = vm.build_dense_lookup(tmap, SPEC) if use_lookup else None
    jc, jm, jcov = jvm.neighborhood_moments(jmap, JSPEC, lookup=jl)
    tc, tm, tcov = vm.neighborhood_moments(tmap, SPEC, lookup=tl)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    _assert_moments(tcov, jcov)


def _assert_normals(tn, tv, jn, jv, margin_of):
    jn, jv = np.asarray(jn), np.asarray(jv)
    tn, tv = tn.numpy(), tv.numpy()
    near = np.abs(margin_of) < 1e-6
    np.testing.assert_array_equal(tv[~near], jv[~near])
    # where the planarity test passes by a margin the smallest eigenvalue
    # is isolated, so the eigenvector is defined up to its sign
    clear = jv & (margin_of < -1e-3)
    assert clear.sum() > 50
    dots = np.abs(np.sum(tn[clear] * jn[clear], axis=1))
    assert dots.min() > 1.0 - 1e-4


def test_normals_match_reference(built):
    jmap, tmap = built
    cov = np.asarray(jvm.voxel_covariances(jmap, min_count=5.0))
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    margin = (ev[:, 0] - 0.25 * np.maximum(ev[:, 1], 1e-12)) / np.maximum(
        ev[:, 1], 1e-12)
    _assert_normals(*vm.voxel_normals(tmap), *jvm.voxel_normals(jmap),
                    margin)

    _, _, ncov = jvm.neighborhood_moments(jmap, JSPEC)
    ncov = np.asarray(ncov).astype(np.float64) + 1e-6 * np.eye(3)
    ev = np.linalg.eigvalsh(ncov)
    margin = (ev[:, 0] - 0.25 * np.maximum(ev[:, 1], 1e-12)) / np.maximum(
        ev[:, 1], 1e-12)
    _assert_normals(*vm.voxel_normals_neighborhood(tmap, SPEC),
                    *jvm.voxel_normals_neighborhood(jmap, JSPEC), margin)
