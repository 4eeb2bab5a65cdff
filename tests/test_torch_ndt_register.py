"""The port's ndt_register (kernel path) against tpu_slam's (CPU).

Both sides get the same map cloud, the same scan and the same perturbed
init. The reference runs its Pallas path with ndt_terms_raster swapped for
ndt_terms_raster_reference (the XLA twin its own tests compare the kernel
with); the port runs ndt_terms_plain. The solve exercises the yaw search,
the GNC coarse stage, staged re-binning, the far tier and the motion prior.
"""

import dataclasses

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
from tpu_slam.mapping import dense_map as jdm
from tpu_slam.mapping.voxel_map import coarse_spec_of as j_coarse_spec_of
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam.registration.ndt import ndt_register as j_register
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import dense_map as dm
from tpu_slam_torch.mapping.voxel_map import coarse_spec_of
from tpu_slam_torch.registration.ndt import NDTParams, ndt_register

DIMS = (32, 32, 16)
HALF = 16.0


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    return j_terms.ndt_terms_raster_reference(raster, planes, T, gamma,
                                              max_corr_dist, dims, q_cap)


@pytest.fixture(scope="module")
def case():
    world = syn.default_office()
    jworld = jsyn.default_office()
    rng = np.random.default_rng(0)
    map_pts, scans = [], []
    poses = [jsyn.se2_pose(-0.5, -0.2, 0.0, z=1.2),
             jsyn.se2_pose(0.6, 0.3, 0.25, z=1.2),
             jsyn.se2_pose(0.1, 0.0, 0.1, z=1.2)]
    for T in poses:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=400, noise_std=0.005, rng=rng)
        # the copied simulator is the reference's numpy path, unchanged
        jpts, jvalid = jsyn.simulate_vlp16_revolution(
            jworld, T, n_azimuth=400, noise_std=0.0)
        assert np.array_equal(valid, jvalid)
        scans.append(pts[valid])
        map_pts.append(pts[valid] @ T[:3, :3].T.astype(np.float32)
                       + T[:3, 3].astype(np.float32))
    return poses, np.concatenate(map_pts[:2]), scans[2]


def test_ndt_register_matches_reference(case, monkeypatch):
    poses, map_pts, scan_pts = case
    monkeypatch.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    jspec = JSpec.centered(leaf=0.4, half_extent=HALF)
    spec = VoxelGridSpec.centered(leaf=0.4, half_extent=HALF)
    jcoarse = j_coarse_spec_of(jspec, 2)
    coarse = coarse_spec_of(spec, 2)
    T_true = poses[2].astype(np.float32)
    # an init off by 0.25 m and 0.08 rad of yaw: the yaw search and the
    # coarse stage have work to do
    err = np.asarray(jse3.exp(jnp.asarray(
        np.array([0.2, -0.15, 0.03, 0.0, 0.01, 0.08], np.float32))))
    init = (err @ T_true).astype(np.float32)

    kw = dict(max_iterations=8, coarse_iterations=2, tolerance=3e-4,
              min_voxel_count=3.0, window_dims=DIMS, yaw_candidates=5,
              motion_prior_weight=2.0, rebin_iters=3)
    jparams = JParams(terms_impl="pallas_interpret", **kw)
    params = NDTParams(**kw)

    jmap = JCloud.from_points_host(map_pts, capacity=16384)
    tmap = PointCloud.from_points_host(map_pts, capacity=16384, device="cpu")
    c_fine = dm.centered_origin_cell(torch.as_tensor(T_true[:3, 3]), spec,
                                     DIMS, 2)
    c_wide = dm.centered_origin_cell(torch.as_tensor(T_true[:3, 3]), coarse,
                                     DIMS, 1)
    jf = jdm.grid_ndt_field(
        jdm.grid_insert(jdm.empty_grid(DIMS, jnp.asarray(c_fine.numpy())),
                        jmap, jspec), jspec, min_voxel_count=3.0)
    jw = jdm.grid_ndt_field(
        jdm.grid_insert(jdm.empty_grid(DIMS, jnp.asarray(c_wide.numpy())),
                        jmap, jcoarse), jcoarse, min_voxel_count=3.0)
    tf = dm.grid_ndt_field(dm.grid_insert(dm.empty_grid(DIMS, c_fine), tmap,
                                          spec), spec, min_voxel_count=3.0)
    tw = dm.grid_ndt_field(dm.grid_insert(dm.empty_grid(DIMS, c_wide), tmap,
                                          coarse), coarse,
                           min_voxel_count=3.0)

    ds_j = JSpec.centered(leaf=0.2, half_extent=HALF)
    ds_t = VoxelGridSpec.centered(leaf=0.2, half_extent=HALF)
    jscan = j_downsample(JCloud.from_points_host(scan_pts, 8192), ds_j,
                         capacity=4096)
    tscan = voxel_downsample(PointCloud.from_points_host(
        scan_pts, 8192, device="cpu"), ds_t, capacity=4096)

    ref = j_register(jscan, jf, jspec, init_T=jnp.asarray(init),
                     params=jparams, far_field=jw, far_spec=jcoarse)
    n_plain = ndt_terms_plain.launches
    got = ndt_register(tscan, tf, spec, init_T=torch.as_tensor(init),
                       params=params, far_field=tw, far_spec=coarse)
    assert ndt_terms_plain.launches > n_plain      # CPU -> plain version
    T_ref = np.asarray(ref.T)
    T_got = got.T.numpy()
    # both converge to the same optimum; float32 sums in other orders
    # move the final iterate by well under a millimetre
    np.testing.assert_allclose(T_got, T_ref, atol=5e-4)
    assert got.iterations == int(ref.iterations)
    assert abs(float(got.matched_fraction)
               - float(ref.matched_fraction)) <= 2e-3
    assert bool(got.converged) == bool(ref.converged)
    # and the solve did its job: within 2 cm of the true pose
    assert np.linalg.norm(T_got[:3, 3] - T_true[:3, 3]) < 0.02


def test_ndt_register_rejects_sparse_only_options():
    field = dm.grid_ndt_field(dm.empty_grid((8, 8, 8), (0, 0, 0)),
                              VoxelGridSpec(leaf=0.5))
    cloud = PointCloud.from_points_host(np.zeros((4, 3)), 8, device="cpu")
    with pytest.raises(ValueError):
        ndt_register(cloud, field, VoxelGridSpec(leaf=0.5),
                     params=NDTParams(isotropic_iterations=2,
                                      window_dims=(8, 8, 8)))
    # an empty field scores nothing and the solve stays at its init
    res = ndt_register(cloud, field, VoxelGridSpec(leaf=0.5),
                       params=NDTParams(window_dims=(8, 8, 8),
                                        max_iterations=3))
    assert torch.equal(res.T, torch.eye(4))
    assert float(res.matched_fraction) == 0.0
    assert ndt_terms.launches == 0                  # never on the CPU
    assert dataclasses.is_dataclass(res)
