"""The compiled programs' sync-free bodies against their host-exit forms
(CPU).

``grid_scroll`` with a device shift against the roll form it replaced and
against tpu_slam's; ``lm_schedule``'s sync-free form against its host-exit
form (coarse, staged fine, far tier, an exit on lam >= 1e6); the dense
engine's ``compiled`` step against ``compiled=False`` with the options off
and on, its body run under a guard that makes every read back to the host
raise; the chunked PCG against the check-every-16 loop it was cut from,
and ``optimize_pose_graph`` against tpu_slam's. The CUDA graphs themselves
are held in ``test_torch_cuda.py``.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.graph import pose_graph as jpg
from tpu_slam.mapping.dense_map import DenseMomentGrid as JGrid
from tpu_slam.mapping.dense_map import grid_scroll as j_grid_scroll
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph import pose_graph as pg
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping.dense_map import (DenseMomentGrid,
                                              centered_origin_cell,
                                              empty_grid, grid_insert,
                                              grid_ndt_field, grid_scroll)
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
from tpu_slam_torch.registration.ndt import (NDTParams, lm_schedule,
                                             ndt_register)

DIMS = (12, 10, 8)
ALIGN = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# grid_scroll
# ---------------------------------------------------------------------------

def _roll_scroll(grid, shift):
    """The host-read form grid_scroll had: the shift read back, a roll with
    static sizes, the vacated slabs zeroed."""
    s = [int(v) for v in shift.tolist()]
    if not any(s):
        return grid
    wx, wy, wz = grid.dims
    ch = grid.rows.shape[-1]
    a = torch.roll(grid.rows.reshape(wx, wy, wz, ch),
                   shifts=[-v for v in s], dims=[0, 1, 2]).clone()
    for ax, v in enumerate(s):
        n_ax = grid.dims[ax]
        if v > 0:
            a.narrow(ax, max(n_ax - v, 0), min(v, n_ax)).zero_()
        elif v < 0:
            a.narrow(ax, 0, min(-v, n_ax)).zero_()
    return DenseMomentGrid(rows=a.reshape(-1, ch),
                           origin_cell=grid.origin_cell + shift.to(torch.int32),
                           dims=grid.dims)


def _shifts():
    out = []
    for ax, d in enumerate(DIMS):
        for v in (0, 1, -1, ALIGN, -ALIGN, d - 1, -(d - 1), d, -d, d + 3):
            s = [0, 0, 0]
            s[ax] = v
            out.append(tuple(s))
    return out + [(1, -2, 3), (-ALIGN, ALIGN, -1), (DIMS[0], 1, -1)]


@pytest.mark.parametrize("shift", _shifts())
@pytest.mark.parametrize("channels", [10, 1])
def test_grid_scroll_device_shift_matches_roll_and_reference(shift,
                                                             channels):
    rng = np.random.default_rng(abs(hash((shift, channels))) % 2**32)
    g = int(np.prod(DIMS))
    rows = rng.normal(size=(g, channels)).astype(np.float32)
    rows[rng.random(g) < 0.3] = 0.0
    rows[0, 0] = -0.0
    oc = np.array([5, -3, 7], np.int32)
    grid = DenseMomentGrid(rows=torch.from_numpy(rows),
                           origin_cell=torch.from_numpy(oc), dims=DIMS)
    sh = torch.tensor(shift, dtype=torch.int32)
    got = grid_scroll(grid, sh)
    ref = _roll_scroll(grid, sh)
    assert torch.equal(got.origin_cell, ref.origin_cell)
    # bit for bit, the sign of zero included
    assert np.array_equal(got.rows.numpy().view(np.uint32),
                          ref.rows.numpy().view(np.uint32))
    jg = j_grid_scroll(JGrid(rows=jnp.asarray(rows), origin_cell=jnp.asarray(
        oc), dims=DIMS), jnp.asarray(shift, jnp.int32))
    assert np.array_equal(got.rows.numpy().view(np.uint32),
                          np.asarray(jg.rows).view(np.uint32))
    assert np.array_equal(got.origin_cell.numpy(), np.asarray(jg.origin_cell))


# ---------------------------------------------------------------------------
# lm_schedule: sync-free against host-exit
# ---------------------------------------------------------------------------

def _office_clouds(n=2, n_azimuth=400, capacity=8192):
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


@pytest.fixture(scope="module")
def fields():
    """A fine (16, 16, 8) window at 0.4 m and a wide one at 0.8 m built from
    the office's first scan, the second scan downsampled, its true pose."""
    clouds, gt = _office_clouds()
    T0 = torch.from_numpy(gt[0])
    out = {}
    for name, leaf in (("fine", 0.4), ("wide", 0.8)):
        spec = VoxelGridSpec.centered(leaf=leaf, half_extent=16.0)
        c0 = centered_origin_cell(T0[:3, 3], spec, (16, 16, 8), align=1)
        grid = grid_insert(empty_grid((16, 16, 8), c0),
                           clouds[0].transform(T0), spec)
        out[name] = (grid_ndt_field(grid, spec, min_voxel_count=3.0), spec)
    scan = voxel_downsample(clouds[1], VoxelGridSpec.centered(
        leaf=0.2, half_extent=16.0), capacity=2048)
    return out, scan, torch.from_numpy(gt[1])


def _results_equal(a, b):
    assert torch.equal(a.T, b.T)
    assert torch.equal(a.score, b.score)
    assert torch.equal(a.matched_fraction, b.matched_fraction)
    assert torch.equal(a.converged, b.converged)
    assert isinstance(a.iterations, int)
    assert b.iterations.dtype == torch.int32 and b.iterations.dim() == 0
    assert int(b.iterations) == a.iterations


LM_CASES = {
    # the coarse stage: yaw search, then GNC re-binned every iteration
    "coarse": dict(field="wide", params=dict(
        max_iterations=6, coarse_iterations=3, raster_q=8, yaw_candidates=5,
        yaw_span=0.3, max_corr_dist=2.0)),
    # the fine stage re-binned every 4 of 10 iterations, no GNC
    "staged_fine": dict(field="fine", params=dict(
        max_iterations=10, coarse_iterations=0, rebin_iters=4)),
    # the fine stage with the far tier, GNC and the motion prior
    "far_tier": dict(field="fine", far=True, params=dict(
        max_iterations=10, coarse_iterations=2, motion_prior_weight=5.0)),
}


@pytest.mark.parametrize("case", sorted(LM_CASES))
@pytest.mark.parametrize("offset", [0, 1])
def test_sync_free_ndt_register_matches_host_exit(fields, case, offset):
    out, scan, T_true = fields
    spec_case = LM_CASES[case]
    field, spec = out[spec_case["field"]]
    params = NDTParams(tolerance=3e-4, min_voxel_count=3.0,
                       window_dims=(16, 16, 8), **spec_case["params"])
    xi = torch.tensor([0.15, -0.1, 0.03, 0.0, 0.0, 0.06]) * offset
    init = se3.exp(xi) @ T_true
    kw = {}
    if spec_case.get("far"):
        kw = dict(far_field=out["wide"][0], far_spec=out["wide"][1])
    host = ndt_register(scan, field, spec, init_T=init, params=params, **kw)
    free = ndt_register(scan, field, spec, init_T=init, params=params,
                        sync_free=True, **kw)
    _results_equal(host, free)


def _uphill_terms(T, gamma, ctx):
    """Terms whose every LM trial is rejected: the gradient points uphill
    of a cost that grows with any translation, so lam climbs by 5x a trial
    until lam >= 1e6 stops the solve (15 trials from 1e-4)."""
    H = torch.eye(6)
    b = torch.full((6,), 0.5)
    cost = torch.sum(T[:3, 3] * T[:3, 3])
    return H, b, cost, torch.ones(())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sync_free_lm_exits_on_lambda(use_kernel):
    params = NDTParams(max_iterations=30, coarse_iterations=0,
                       rebin_iters=20, tolerance=1e-4)
    runs = [lm_schedule(torch.eye(4), params, use_kernel, _uphill_terms,
                        lambda T: None, None, sync_free=free)
            for free in (False, True)]
    (T0, it0, f0, c0, dx0), (T1, it1, f1, c1, dx1) = runs
    # 15 rejected trials in the solve or the first stage of 20, then
    # (kernel path) 15 more in the second, since dx never fell below the
    # tolerance
    assert it0 == (15 + 15 if use_kernel else 15)
    assert int(it1) == it0
    for a, b in ((T0, T1), (f0, f1), (c0, c1), (dx0, dx1)):
        assert torch.equal(a, b)
    assert math.isinf(float(dx1))


# ---------------------------------------------------------------------------
# DenseLidarOdometry: compiled (the sync-free body) against compiled=False
# ---------------------------------------------------------------------------

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


def _odometry_config(**kw):
    return OdometryConfig(
        scan_capacity=2048, downsample_leaf=0.2, map_leaf=0.4,
        map_half_extent=16.0, scan_max_range=12.0, insert_downsampled=True,
        ndt=NDTParams(max_iterations=8, coarse_iterations=2, tolerance=3e-4,
                      min_voxel_count=3.0, window_dims=(24, 24, 12)),
        pyramid_factor=2, rebase_fraction=0.05, **kw)


@pytest.mark.parametrize("options", [False, True])
def test_compiled_step_matches_host_exit_step(options):
    clouds, gt = _office_clouds(n=4)
    kw = dict(deskew=True, use_occupancy=True) if options else {}
    runs = []
    for compiled in (False, True):
        eng = DenseLidarOdometry(_odometry_config(**kw), device="cpu",
                                 compiled=compiled)
        state = eng.init_state(clouds[0], gt[0])
        states = []
        for c in clouds[1:]:
            with _no_host_reads() if compiled else contextlib.nullcontext():
                state = eng.step(state, c)
            states.append(state)
        runs.append((states, eng.n_evicted))
    (host, ev_host), (free, ev_free) = runs
    for a, b in zip(host, free):
        for f in ("pose", "last_delta", "scan_index", "last_metrics"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for g in ("grid", "wide", "occ"):
            ga, gb = getattr(a, g), getattr(b, g)
            assert (ga is None) == (gb is None)
            if ga is not None:
                assert torch.equal(ga.rows, gb.rows), g
                assert torch.equal(ga.origin_cell, gb.origin_cell), g
    # the window scrolled (rebase_fraction 0.05), the solves iterated
    assert not torch.equal(host[0].grid.origin_cell,
                           host[-1].grid.origin_cell)
    assert all(float(s.last_metrics[0]) > 0 for s in host)
    if options:
        assert int(ev_host) == int(ev_free)


def test_step_impl_returns_device_values_only():
    clouds, gt = _office_clouds(n=2)
    eng = DenseLidarOdometry(_odometry_config(use_occupancy=True),
                             device="cpu")
    state = eng.init_state(clouds[0], gt[0])
    with _no_host_reads():
        nxt, n_ev = eng._step_impl(state, clouds[1])
    assert nxt.last_metrics.dtype == torch.float32
    assert n_ev.dtype == torch.int32 and n_ev.dim() == 0
    # the old state is left intact
    assert torch.equal(state.pose, torch.from_numpy(gt[0]))


# ---------------------------------------------------------------------------
# The pose graph: the chunked PCG against the check-every-16 loop
# ---------------------------------------------------------------------------

def _check_every_16(graph, params, b, diag, edge_terms):
    """The PCG loop the chunks were cut from: masked iterations, the flag
    read at every 16th."""
    Minv = torch.linalg.inv_ex(diag)[0]

    def precond(x):
        return torch.einsum("nab,nb->na", Minv, x)

    def dot(a, c):
        return torch.sum(a * c)

    x = torch.zeros_like(b)
    r = b - pg._hv(graph, params, edge_terms, x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    for it in range(params.cg_iterations):
        active = dot(r, r) > params.cg_tolerance
        if it % 16 == 0 and not bool(active):
            break
        Hp = pg._hv(graph, params, edge_terms, p)
        alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Hp
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def _circle_graphs(n=24, cap_n=32, cap_e=64, seed=5):
    """test_torch_pose_graph.py's noisy circle with its wrong loop (3, 18),
    in both packages."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(n):
        a = 2 * math.pi * k / n
        c, s = math.cos(a), math.sin(a)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [3.0 * c, 3.0 * s, 0.1 * math.sin(3 * a)]
        gt.append(T)

    def exp(xi):
        return se3.exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()

    est, edges = [gt[0]], []
    for k in range(n - 1):
        Z = np.linalg.inv(gt[k]) @ gt[k + 1]
        Zn = (exp(rng.normal(0, 0.02, 6)) @ Z).astype(np.float32)
        edges.append((k, k + 1, Zn, 100.0 * np.eye(6, dtype=np.float32)))
        est.append((est[-1] @ Zn).astype(np.float32))
    edges.append((0, n - 1, (np.linalg.inv(gt[0]) @ gt[n - 1])
                  .astype(np.float32), 10.0 * np.eye(6, dtype=np.float32)))
    Zb = (exp([1.5, -1.0, 0.5, 0.3, 0.2, 0.6])
          @ (np.linalg.inv(gt[3]) @ gt[18])).astype(np.float32)
    edges.append((3, 18, Zb, 25.0 * np.eye(6, dtype=np.float32)))
    jg = jpg.empty_graph(cap_n, cap_e)
    tg = pg.empty_graph(cap_n, cap_e, device="cpu")
    for T in est:
        jg, _ = jpg.add_node(jg, jnp.asarray(T))
        tg, _ = pg.add_node(tg, torch.as_tensor(T))
    for i, j, Z, info in edges:
        jg = jpg.add_edge(jg, i, j, jnp.asarray(Z), jnp.asarray(info))
        tg = pg.add_edge(tg, i, j, torch.as_tensor(Z), torch.as_tensor(info))
    return jg, tg


@pytest.mark.parametrize("cg_iterations, tol", [(50, 1e-8), (200, 1e-8),
                                                 (40, 1e-3), (7, 1e-8)])
def test_chunked_pcg_matches_check_every_16_loop(cg_iterations, tol):
    _, tg = _circle_graphs()
    params = pg.GraphSolveParams(cg_iterations=cg_iterations,
                                 cg_tolerance=tol, robust_delta=0.3)
    b, diag, terms = pg._build_rhs_and_diag(tg, params, 0.3)
    got = pg._solve_pcg(tg, params, b, diag, terms)
    ref = _check_every_16(tg, params, b, diag, terms)
    assert torch.equal(got, ref)
    assert pg._chunks(params)[-1] == (cg_iterations - 1) % 16 + 1
    assert sum(pg._chunks(params)) == cg_iterations


def test_optimize_pose_graph_matches_reference_on_both_forms():
    jg, tg = _circle_graphs()
    kw = dict(gn_iterations=12, cg_iterations=200, robust_delta=0.3,
              trust_loops=True)
    jout, _ = jpg.optimize_pose_graph(jg, jpg.GraphSolveParams(**kw))
    out, chi = pg.optimize_pose_graph(tg, pg.GraphSolveParams(**kw))
    eager, chi_e = pg.optimize_pose_graph(tg, pg.GraphSolveParams(**kw),
                                          compiled=False)
    # test_torch_pose_graph.py's bar for this case (the wrong loop trusted)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(jout.poses),
                               atol=3e-4)
    assert torch.equal(out.poses, eager.poses) and torch.equal(chi, chi_e)
