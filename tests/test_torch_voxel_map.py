"""The port's sparse voxel map and the dense field built from it against
tpu_slam (CPU): ``build_map_host``, ``coarsen_map``, ``ndt_field`` on its
``window_dims`` branch, and config 3's registration (coarse stage on the
coarsened map's field, then the fine window with the far tier) at a small
map.

Tolerances: the host build is bit-equal; coarsened keys, counts and
stamps exact, moments within 1e-5 of each channel's largest magnitude;
field rows against the reference's planes with the origin cell and valid
flags exact and means and information within 2e-4 (the reference's own
tolerance for its dense field, ``tests/test_dense_map.py``); the raster's
dropped count exact; registered poses within 5e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.ingest import synthetic as jsyn
from tpu_slam.kernels.downsample import voxel_downsample as j_downsample
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.mapping import voxel_map as jvm
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam.registration.ndt import ndt_field as j_ndt_field
from tpu_slam.registration.ndt import ndt_register as j_register
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.ndt_terms import build_terms_raster
from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam_torch.mapping import voxel_map as vm
from tpu_slam_torch.registration.ndt import NDTParams, ndt_field, ndt_register

LEAF, HALF = 0.5, 16.0
SPEC = VoxelGridSpec.centered(leaf=LEAF, half_extent=HALF)
JSPEC = JSpec.centered(leaf=LEAF, half_extent=HALF)
FINE = (24, 24, 8)
COARSE = (8, 8, 8)
CAPACITY = 8192


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


@pytest.fixture(scope="module")
def maps():
    surf = syn.sample_world_surface(syn.default_office(), spacing=0.15,
                                    noise_std=0.01, seed=1)
    jmap = jvm.build_map_host(surf, JSPEC, capacity=CAPACITY, stamp=3.0)
    tmap = vm.build_map_host(surf, SPEC, capacity=CAPACITY, stamp=3.0,
                             device="cpu")
    return surf, jmap, tmap


def _arrays(m):
    return [np.asarray(getattr(m, k)) if not torch.is_tensor(getattr(m, k))
            else getattr(m, k).numpy()
            for k in ("keys", "count", "sum_pts", "sum_outer", "stamp")]


def _planes_as_rows(planes, dims):
    wx, wy, wz = dims
    p = np.asarray(planes).reshape(wx, 16, 8, wy, wz // 8)
    return p.transpose(0, 3, 4, 2, 1).reshape(-1, 16)


def test_sample_world_surface_and_build_map_host_bit_equal(maps):
    surf, jmap, tmap = maps
    ref = jsyn.sample_world_surface(jsyn.default_office(), spacing=0.15,
                                    noise_std=0.01, seed=1)
    assert surf.dtype == ref.dtype and np.array_equal(surf, ref)
    for got, want in zip(_arrays(tmap), _arrays(jmap)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    n = int(tmap.n_occupied())
    assert n == int(jmap.n_occupied()) > 1000
    assert bool(tmap.occupied_mask()[:n].all())
    corner = vm.decode_corner(tmap.keys[:n], SPEC).numpy()
    np.testing.assert_array_equal(corner, np.asarray(
        jvm.decode_corner(jmap.keys[:n], JSPEC)))
    with pytest.raises(ValueError):
        vm.build_map_host(surf, SPEC, capacity=100, device="cpu")
    empty = vm.empty_map(16, device="cpu")
    assert int(empty.n_occupied()) == 0
    assert bool((empty.keys == INVALID_KEY).all())


@pytest.mark.parametrize("factor", [2, 4])
def test_coarsen_map_matches_reference(maps, factor):
    _, jmap, tmap = maps
    # stamps that differ within a coarse cell: the run's maximum is kept
    stamps = np.where(np.asarray(jmap.keys) != INVALID_KEY,
                      np.arange(CAPACITY, dtype=np.float32) % 7.0, -np.inf
                      ).astype(np.float32)
    jm = jvm.VoxelMap(keys=jmap.keys, count=jmap.count, sum_pts=jmap.sum_pts,
                      sum_outer=jmap.sum_outer, stamp=jnp.asarray(stamps))
    tm = vm.VoxelMap(keys=tmap.keys, count=tmap.count, sum_pts=tmap.sum_pts,
                     sum_outer=tmap.sum_outer, stamp=torch.tensor(stamps))
    ref = _arrays(jvm.coarsen_map(jm, JSPEC, factor))
    got = _arrays(vm.coarsen_map(tm, SPEC, factor))
    for k in (0, 1, 4):                    # keys, counts, stamps
        np.testing.assert_array_equal(got[k], ref[k])
    for k in (2, 3):                       # sums about the coarse corners
        scale = np.abs(ref[k]).reshape(CAPACITY, -1).max(axis=0)
        err = np.abs(got[k] - ref[k]).reshape(CAPACITY, -1)
        assert np.all(err <= 1e-5 * scale), k
    assert (got[0] != INVALID_KEY).sum() < int(tmap.n_occupied())
    with pytest.raises(ValueError):
        vm.coarsen_map(tm, SPEC, 3)


CENTERS = [(0.3, -0.4, 1.1), (-4.7, 3.2, 0.0), (14.0, -15.0, 6.0), None]


@pytest.mark.parametrize("center", CENTERS)
def test_ndt_field_rows_match_reference_planes(maps, center):
    _, jmap, tmap = maps
    kw = dict(min_voxel_count=3.0, window_dims=FINE)
    jf = j_ndt_field(jmap, JSPEC, JParams(terms_impl="pallas_interpret", **kw),
                     center=None if center is None
                     else jnp.asarray(center, jnp.float32))
    tf = ndt_field(tmap, SPEC, NDTParams(**kw),
                   center=None if center is None
                   else torch.tensor(center, dtype=torch.float32))
    assert tf.window_dims == FINE
    np.testing.assert_array_equal(tf.origin_cell.numpy(),
                                  np.asarray(jf.origin_cell))
    ref = _planes_as_rows(jf.planes, FINE)
    got = tf.rows.numpy()
    np.testing.assert_array_equal(got[:, 9], ref[:, 9])
    # the corner case clips the window against the grid's far faces,
    # past the office's walls
    assert got[:, 9].sum() > 50 or center == (14.0, -15.0, 6.0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_ndt_field_whole_grid_window_and_refusals(maps):
    """A window as large as the grid is the grid: corner 0; so is the
    default cube window; window_dims off the kernel path is refused."""
    _, jmap, tmap = maps
    spec = VoxelGridSpec.centered(leaf=1.0, half_extent=8.0)     # 16 cells
    jspec = JSpec.centered(leaf=1.0, half_extent=8.0)
    cm = vm.coarsen_map(tmap, SPEC, 2)
    jcm = jvm.coarsen_map(jmap, JSPEC, 2)
    dims = (16, 16, 16)
    jf = j_ndt_field(jcm, jspec, JParams(terms_impl="pallas_interpret",
                                         window_dims=dims))
    tf = ndt_field(cm, spec, NDTParams(window_dims=(32, 32, 24)))
    assert tf.window_dims == dims and jf.origin_cell is None
    assert tf.origin_cell.tolist() == [0, 0, 0]
    np.testing.assert_allclose(tf.rows.numpy(),
                               _planes_as_rows(jf.planes, dims),
                               rtol=2e-4, atol=2e-4)
    # without window_dims the field is the 2^window_bits cube (64 cells a
    # side here, the whole grid: corner 0), as the reference builds it on
    # its kernel path
    cube = (64, 64, 64)
    jc = j_ndt_field(jmap, JSPEC, JParams(terms_impl="pallas_interpret"))
    tc = ndt_field(tmap, SPEC, NDTParams())
    assert tc.window_dims == cube and jc.window_dims == cube
    assert jc.origin_cell is None and tc.origin_cell.tolist() == [0, 0, 0]
    ref = _planes_as_rows(jc.planes, cube)
    np.testing.assert_array_equal(tc.rows.numpy()[:, 9], ref[:, 9])
    np.testing.assert_allclose(tc.rows.numpy(), ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        ndt_field(tmap, SPEC, NDTParams(window_dims=FINE,
                                        use_neighborhood=False))
    with pytest.raises(ValueError):
        ndt_field(tmap, SPEC, NDTParams(window_dims=FINE, terms_impl="xla"))
    with pytest.raises(ValueError):
        NDTParams(terms_impl="pallas")


def test_config3_register_matches_reference(maps, monkeypatch):
    """bench_ndt_register's solve at a small map: the coarse stage on the
    coarsened map's field, then the fine window with the far tier, from
    the bench's perturbation."""
    _, jmap, tmap = maps
    monkeypatch.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    T_pose = syn.se2_pose(-0.5, -0.2, 0.3, z=1.2)
    rng = np.random.default_rng(0)
    pts, valid = syn.simulate_vlp16_revolution(
        syn.default_office(), T_pose, n_azimuth=400, noise_std=0.01, rng=rng)
    pts = pts[valid]

    ds = dict(half_extent=HALF)
    jscan = j_downsample(JCloud.from_points_host(pts, 8192),
                         JSpec.centered(leaf=0.2, **ds), capacity=4096)
    tscan = voxel_downsample(PointCloud.from_points_host(pts, 8192,
                                                         device="cpu"),
                             VoxelGridSpec.centered(leaf=0.2, **ds),
                             capacity=4096)
    jcscan = j_downsample(JCloud.from_points_host(pts, 8192),
                          JSpec.centered(leaf=1.0, **ds), capacity=1024)
    tcscan = voxel_downsample(PointCloud.from_points_host(pts, 8192,
                                                          device="cpu"),
                              VoxelGridSpec.centered(leaf=1.0, **ds),
                              capacity=1024)
    fkw = dict(max_iterations=5, coarse_iterations=0, tolerance=1e-3,
               min_voxel_count=3.0, rebin_iters=5, window_dims=FINE)
    ckw = dict(max_iterations=3, coarse_iterations=2, max_corr_dist=4.0,
               window_dims=COARSE)
    jcspec = jvm.coarse_spec_of(JSPEC, 4)
    cspec = vm.coarse_spec_of(SPEC, 4)
    Tw = T_pose.astype(np.float32)
    jfp = JParams(terms_impl="pallas_interpret", **fkw)
    jcp = JParams(terms_impl="pallas_interpret", **ckw)
    jcf = j_ndt_field(jvm.coarsen_map(jmap, JSPEC, 4), jcspec, jcp,
                      center=jnp.asarray(Tw[:3, 3]))
    jff = j_ndt_field(jmap, JSPEC, jfp, center=jnp.asarray(Tw[:3, 3]))
    fp, cp = NDTParams(**fkw), NDTParams(**ckw)
    tcf = ndt_field(vm.coarsen_map(tmap, SPEC, 4), cspec, cp,
                    center=torch.tensor(Tw[:3, 3]))
    tff = ndt_field(tmap, SPEC, fp, center=torch.tensor(Tw[:3, 3]))

    xi = np.asarray([0.2, -0.15, 0.08, 0.025, -0.015, 0.04], np.float32)
    E_inv = np.asarray(jse3.inverse(jse3.exp(jnp.asarray(xi))))
    T_true = Tw @ np.asarray(jse3.exp(jnp.asarray(xi)))

    def jreg(scan, cscan):
        r0 = j_register(cscan.transform(jnp.asarray(E_inv)), jcf, jcspec,
                        init_T=jnp.asarray(Tw), params=jcp)
        return j_register(scan.transform(jnp.asarray(E_inv)), jff, JSPEC,
                          init_T=r0.T, params=jfp, far_field=jcf,
                          far_spec=jcspec)

    def treg(scan, cscan):
        E = torch.tensor(E_inv)
        r0 = ndt_register(cscan.transform(E), tcf, cspec,
                          init_T=torch.tensor(Tw), params=cp)
        return ndt_register(scan.transform(E), tff, SPEC, init_T=r0.T,
                            params=fp, far_field=tcf, far_spec=cspec)

    ref, got = jreg(jscan, jcscan), treg(tscan, tcscan)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=5e-4)
    assert got.iterations == int(ref.iterations)
    assert abs(float(got.matched_fraction)
               - float(ref.matched_fraction)) <= 2e-3
    err = se3.log(torch.tensor(np.linalg.inv(T_true), dtype=torch.float32)
                  @ got.T)
    # the solve pulled the 0.26 m perturbation in to a few centimetres
    # (5 fine iterations at tolerance 1e-3 on an office-sized map)
    assert float(torch.linalg.vector_norm(err[:3])) < 0.08

    # raster_dropped: the fine raster of the scan at the true pose
    sane = tscan.sanitize()
    jsane = jscan.sanitize()
    origin_w = (np.asarray(SPEC.origin, np.float32)
                + tff.origin_cell.numpy().astype(np.float32) * LEAF)
    _, jdrop = j_terms.build_terms_raster(
        jsane.points, jsane.mask, jnp.asarray(Tw), jnp.asarray(origin_w),
        LEAF, FINE, 4)
    _, tdrop = build_terms_raster(sane.points, sane.mask, torch.tensor(Tw),
                                  torch.tensor(origin_w), LEAF, FINE, 4)
    assert int(tdrop) == int(jdrop) > 0
