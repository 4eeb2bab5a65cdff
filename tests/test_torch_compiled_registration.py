"""The registration layer's compiled programs: their sync-free bodies
against their host-exit forms (CPU).

On the CPU ``compiled=True`` runs the body the card captures into a CUDA
graph, eagerly; ``compiled=False`` runs the form whose loops read their
exits back. Held here, bit for bit: ``compiled_register`` (``ndt_register``)
on the kernel path with and without the far tier and yaw candidates and on
the sparse path with and without its isotropic stage, with every read back
to the host made to raise; ``LidarOdometry`` and ``JitLidarOdometry`` over
a few scans on both paths (the jit engine's compiled step under the same
guard); ``icp_raster`` with a stage that converges early, the iteration
cap, ``axis_perm`` and the default origin. The sync-free ``icp_raster``
counts the iterations tpu_slam's counts on the same inputs (its terms pass
run through its plain version, as its own tests may). The CUDA graphs
themselves are held in ``test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.icp_terms import icp_terms_plain
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping.voxel_map import (coarse_spec_of, coarsen_map,
                                              empty_map, insert_cloud)
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.odometry import LidarOdometry
from tpu_slam_torch.pipeline.odometry_jit import JitLidarOdometry
from tpu_slam_torch.registration.icp import ICPParams, icp_raster
from tpu_slam_torch.registration.ndt import (NDTParams, compiled_register,
                                             ndt_field)
from tpu_slam_torch.utils.capture import signature, tensors_of

LEAF = 0.4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_host_reads():
    """Make every read of a tensor's value back to the host raise."""
    def boom(*a, **k):
        raise AssertionError("a value was read back to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                     "__float__"):
            mp.setattr(torch.Tensor, name, boom)
        yield


def _office_clouds(n, n_azimuth=300, capacity=6144):
    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(n):
        T = syn.se2_pose(0.3 * k - 0.6, 0.12 * k - 0.3, 0.07 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=capacity,
                                                  device="cpu"))
        gt.append(T)
    return clouds, np.stack(gt).astype(np.float32)


def _same(a, b):
    """Every tensor of two results or states equal, bit for bit."""
    assert signature(a) == signature(b)
    for x, y in zip(tensors_of(a), tensors_of(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# compiled_register (ndt_register)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def office_map():
    """The office's first scan in a 0.4 m map, the second scan downsampled
    at 0.2 m, its true pose."""
    clouds, gt = _office_clouds(2)
    spec = VoxelGridSpec.centered(leaf=LEAF, half_extent=16.0)
    T0 = torch.from_numpy(gt[0])
    vmap = insert_cloud(empty_map(16384, device="cpu"),
                        clouds[0].transform(T0), spec)
    from tpu_slam_torch.kernels.downsample import voxel_downsample
    scan = voxel_downsample(clouds[1], VoxelGridSpec.centered(
        leaf=0.2, half_extent=16.0), capacity=2048)
    return vmap, spec, scan, torch.from_numpy(gt[1])


NDT_CASES = {
    "kernel": dict(window_dims=(16, 16, 8), max_iterations=10,
                   coarse_iterations=2),
    "kernel_yaw": dict(window_dims=(16, 16, 8), max_iterations=6,
                       coarse_iterations=3, yaw_candidates=5,
                       raster_q=8, max_corr_dist=2.0),
    "kernel_far": dict(window_dims=(12, 12, 8), max_iterations=10,
                       coarse_iterations=2, motion_prior_weight=5.0),
    "sparse": dict(terms_impl="xla", max_iterations=10,
                   coarse_iterations=2),
    "sparse_isotropic": dict(terms_impl="xla", max_iterations=8,
                             coarse_iterations=2, isotropic_iterations=3),
}


@pytest.mark.parametrize("case", sorted(NDT_CASES))
def test_compiled_register_matches_host_exit(office_map, case):
    vmap, spec, scan, T_true = office_map
    params = NDTParams(tolerance=3e-4, min_voxel_count=3.0,
                       **NDT_CASES[case])
    field = ndt_field(vmap, spec, params, center=T_true[:3, 3])
    assert (field.rows is None) == case.startswith("sparse")
    kw = {}
    if case == "kernel_far":
        cspec = coarse_spec_of(spec, 2)
        kw = dict(far_field=ndt_field(coarsen_map(vmap, spec, 2), cspec,
                                      dataclasses.replace(params),
                                      center=T_true[:3, 3]),
                  far_spec=cspec)
    init = se3.exp(torch.tensor([0.15, -0.1, 0.03, 0.0, 0.0, 0.06])) @ T_true
    host = compiled_register(scan, field, spec, init_T=init, params=params,
                             compiled=False, **kw)
    with _no_host_reads():
        free = compiled_register(scan, field, spec, init_T=init,
                                 params=params, **kw)
    assert isinstance(host.iterations, int) and host.iterations > 0
    assert free.iterations.dtype == torch.int32
    assert int(free.iterations) == host.iterations
    for f in ("T", "score", "matched_fraction", "converged"):
        assert torch.equal(getattr(host, f), getattr(free, f)), f


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

def _odometry_config(path, **kw):
    ndt = (NDTParams(max_iterations=8, coarse_iterations=2, tolerance=3e-4,
                     min_voxel_count=3.0, window_dims=(40, 40, 16))
           if path == "kernel" else
           NDTParams(max_iterations=8, coarse_iterations=2, tolerance=3e-4,
                     terms_impl="xla"))
    return OdometryConfig(scan_capacity=2048, downsample_leaf=0.25,
                          map_leaf=LEAF, map_half_extent=16.0,
                          map_capacity=16384, ndt=ndt, **kw)


@pytest.mark.parametrize("path", ["kernel", "sparse"])
def test_host_engine_compiled_matches_host_exit(path):
    clouds, gt = _office_clouds(4)
    # the kernel path with the coarse pyramid stage before the fine one
    cfg = _odometry_config(path, pyramid_factor=2 if path == "kernel" else 0)
    runs = []
    for compiled in (False, True):
        eng = LidarOdometry(cfg, device="cpu", compiled=compiled)
        poses, log = eng.run(clouds, init_pose=gt[0])
        runs.append((poses, log.records, eng.field_builds))
    (p0, m0, b0), (p1, m1, b1) = runs
    assert np.array_equal(p0, p1)
    assert [m.iterations for m in m0] == [m.iterations for m in m1]
    assert [m.matched_fraction for m in m0] == [m.matched_fraction
                                                for m in m1]
    assert b0 == b1
    assert all(m.iterations > 0 for m in m0[1:])


@pytest.mark.parametrize("path", ["kernel", "sparse"])
def test_jit_engine_compiled_step_matches_host_exit(path):
    clouds, gt = _office_clouds(4)
    cfg = _odometry_config(path)
    runs = []
    for compiled in (False, True):
        eng = JitLidarOdometry(cfg, device="cpu", compiled=compiled)
        state = eng.init_state(clouds[0], gt[0])
        states = []
        for c in clouds[1:]:
            with _no_host_reads() if compiled else contextlib.nullcontext():
                nxt = eng.step(state, c)
            # the old state is left intact
            assert int(nxt.scan_index) == int(state.scan_index) + 1
            state = nxt
            states.append(state)
        runs.append(states)
    for a, b in zip(*runs):
        _same(a, b)
    assert all(float(s.last_metrics[0]) > 0 for s in runs[0])
    assert all(float(s.last_metrics[3]) == 1.0 for s in runs[0])


# ---------------------------------------------------------------------------
# icp_raster
# ---------------------------------------------------------------------------

DIMS = (16, 16, 8)
ORIGIN = (-4.0, -4.0, -2.0)
XI = (0.1, -0.06, 0.03, 0.015, -0.01, 0.02)


@pytest.fixture(scope="module")
def office_pair():
    """tests/test_icp_raster.py's target, a smaller capture, and the same
    cloud moved by exp(XI)^-1 (numpy points and masks)."""
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(
        syn.default_office(), T0, n_azimuth=128, noise_std=0.005,
        rng=np.random.default_rng(0))
    keep = pts[valid]
    keep = keep[np.all(np.abs(keep[:, :2]) < 3.6, axis=1)]
    tgt = PointCloud.from_points_host(keep, capacity=2048, device="cpu")
    src = tgt.transform(se3.inverse(se3.exp(torch.tensor(XI))))
    return ((src.points.numpy(), src.mask.numpy()),
            (tgt.points.numpy(), tgt.mask.numpy()))


def _cloud(pm):
    return PointCloud(points=torch.from_numpy(pm[0]),
                      mask=torch.from_numpy(pm[1]))


ICP_CASES = {
    # stage one converges before its bound; stage two still runs (its dx
    # starts at inf, as the reference's does)
    "early": dict(params=dict(max_iterations=12, tolerance=1e-2)),
    "to_the_cap": dict(params=dict(max_iterations=4, tolerance=1e-9)),
    "one_iteration": dict(params=dict(max_iterations=1)),
    "axis_perm": dict(params=dict(max_iterations=10), perm=(2, 0, 1)),
    "default_origin": dict(params=dict(max_iterations=10), origin=False),
}


@pytest.mark.parametrize("case", sorted(ICP_CASES))
def test_sync_free_icp_raster_matches_host_exit(office_pair, case):
    spec = ICP_CASES[case]
    perm = spec.get("perm")
    dims, origin = ((8, 16, 16), (-2.0, -4.0, -4.0)) if perm else (DIMS,
                                                                   ORIGIN)
    kw = dict(params=ICPParams(max_corr_dist=1.0, huber_delta=0.4,
                               **spec["params"]),
              dims=dims, leaf=0.5, axis_perm=perm,
              origin_world=(torch.tensor(origin)
                            if spec.get("origin", True) else None))
    src, tgt = _cloud(office_pair[0]), _cloud(office_pair[1])
    n0 = icp_terms_plain.launches
    host = icp_raster(src, tgt, compiled=False, **kw)
    n1 = icp_terms_plain.launches
    with _no_host_reads():
        free = icp_raster(src, tgt, **kw)
    n2 = icp_terms_plain.launches
    _same(host, free)
    it = int(host.iterations)
    m = kw["params"].max_iterations
    # one terms pass an iteration; the sync-free form runs every trip
    assert n1 - n0 == it and n2 - n1 == max(1, m // 2) + m
    if case == "early":
        assert it < m // 2 + 2 and bool(host.converged)
    if case == "to_the_cap":
        assert it == m and not bool(host.converged)
    if case == "one_iteration":
        # stage two has nothing left: its error and fraction stay at their
        # entry values, as the reference's do
        assert it == 1 and math.isinf(float(host.error))


def test_sync_free_icp_raster_counts_the_reference_iterations(
        office_pair, monkeypatch):
    """The early case against tpu_slam's icp_raster, its terms pass
    through its plain version (``icp_terms_raster_reference``)."""
    import tpu_slam.kernels.icp_terms as jterms
    from tpu_slam.core.pointcloud import PointCloud as JCloud
    from tpu_slam.registration.icp import ICPParams as JParams
    from tpu_slam.registration.icp import icp_raster as j_icp_raster

    monkeypatch.setattr(
        jterms, "icp_terms_raster",
        lambda *a, interpret=False: jterms.icp_terms_raster_reference(*a))
    params = dict(max_iterations=12, tolerance=1e-2, max_corr_dist=1.0,
                  huber_delta=0.4)
    (sp, sm), (tp, tm) = office_pair
    ref = j_icp_raster(JCloud(points=jnp.asarray(sp), mask=jnp.asarray(sm)),
                       JCloud(points=jnp.asarray(tp), mask=jnp.asarray(tm)),
                       params=JParams(**params), dims=DIMS, leaf=0.5,
                       origin_world=jnp.asarray(ORIGIN, jnp.float32))
    got = icp_raster(_cloud(office_pair[0]), _cloud(office_pair[1]),
                     params=ICPParams(**params), dims=DIMS, leaf=0.5,
                     origin_world=torch.tensor(ORIGIN))
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    # float32 sums in another order over a few iterations
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), atol=1e-6)
