"""The port's raster pair ICP against tpu_slam's (CPU).

raster_to_slots must equal the reference raster's slot rows exactly. The
terms pass's plain version (which the CUDA wrapper runs for CPU tensors) is
held against the Pallas kernel in interpret mode and against its XLA twin,
on the inputs of tests/test_icp_raster.py and on seeded ties. icp_raster is
held against the reference solve, unpermuted and with axis_perm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.ingest import synthetic as jsyn
from tpu_slam.kernels.icp_terms import icp_terms_raster as j_terms
from tpu_slam.kernels.icp_terms import icp_terms_raster_reference as j_ref
from tpu_slam.kernels.ndt_terms import build_terms_raster as j_build
from tpu_slam.kernels.ndt_terms import raster_to_slots as j_to_slots
from tpu_slam.registration.icp import ICPParams as JParams
from tpu_slam.registration.icp import icp_raster as j_icp_raster
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels import icp_terms
from tpu_slam_torch.kernels.icp_terms import (icp_terms_plain,
                                              icp_terms_raster)
from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                              raster_to_slots)
from tpu_slam_torch.kernels.nn_search import nearest_neighbors_plain
from tpu_slam_torch.registration.icp import (ICPParams, icp_auto, icp_raster,
                                             raster_problem)
from tpu_slam_torch.utils.devtime import slope_time

DIMS = (16, 16, 8)
LEAF = 0.5
ORIGIN = np.array([-4.0, -4.0, -2.0], np.float32)
NAMES = ["H", "b", "err", "nmatch", "wsum"]


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def office():
    """tests/test_icp_raster.py's target (an office scan that fits the
    window, capacity 4,096) as numpy points and mask."""
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.5]
    rng = np.random.default_rng(0)
    pts, valid = jsyn.simulate_vlp16_revolution(
        jsyn.default_office(), T0, n_azimuth=256, noise_std=0.005, rng=rng)
    keep = pts[valid]
    keep = keep[np.all(np.abs(keep[:, :2]) < 3.6, axis=1)]
    tgt = JCloud.from_points(jnp.asarray(keep), capacity=4096)
    return np.array(tgt.points), np.array(tgt.mask)


def _source(office, xi):
    """The target moved by exp(xi)^-1, as the reference's test makes it."""
    tgt = JCloud(points=jnp.asarray(office[0]), mask=jnp.asarray(office[1]))
    src = tgt.transform(jse3.inverse(jse3.exp(jnp.asarray(xi, jnp.float32))))
    return np.array(src.points), np.array(src.mask)


def _both_rasters(src, tgt, T0, origin, dims, qs, qt):
    """(JAX src raster, JAX tgt raster, port src slots, port tgt table)."""
    jsr, _ = j_build(jnp.asarray(src[0]), jnp.asarray(src[1]),
                     jnp.asarray(T0), jnp.asarray(origin), LEAF, dims, qs)
    jtr, _ = j_build(jnp.asarray(tgt[0]), jnp.asarray(tgt[1]),
                     jnp.eye(4, dtype=jnp.float32), jnp.asarray(origin), LEAF,
                     dims, qt)
    slots, _ = build_terms_raster(_t(src[0]), _t(src[1], torch.bool), _t(T0),
                                  _t(origin), LEAF, dims, qs)
    tslots, _ = build_terms_raster(_t(tgt[0]), _t(tgt[1], torch.bool),
                                   torch.eye(4), _t(origin), LEAF, dims, qt)
    return jsr, jtr, slots, raster_to_slots(tslots, dims, qt)


def _scan(dims, n, seed):
    """Points over the window, some outside it, a crowded cell, padding."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(dims) * LEAF
    pts = rng.uniform(-0.3, ext + 0.3, (n, 3)).astype(np.float32)
    pts[:12] = np.float32(0.5 * ext + 0.1)            # 12 points in one cell
    pts[12:20] = rng.uniform(0, LEAF, (8, 3))         # window corner cell
    mask = np.ones(n, bool)
    mask[-15:] = False
    pts[-15:] = 1e8
    return pts, mask


@pytest.mark.parametrize("dims,q,n", [((8, 8, 16), 2, 300),
                                      ((16, 8, 8), 4, 600),
                                      ((8, 16, 8), 8, 900)])
def test_raster_to_slots_equals_reference(dims, q, n):
    pts, mask = _scan(dims, n, seed=q)
    T0 = np.asarray(jse3.exp(jnp.asarray(
        np.random.default_rng(q).normal(0, 0.05, 6), jnp.float32)))
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    raster, dropped = j_build(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(T0), jnp.asarray(origin), LEAF,
                              dims, q)
    slots, n_dropped = build_terms_raster(_t(pts), _t(mask, torch.bool),
                                          _t(T0), _t(origin), LEAF, dims, q)
    # integer binning and copies only: exactly equal, the drop rule (a cell
    # over capacity, points outside the window) included
    assert int(n_dropped) == int(dropped) > 0
    np.testing.assert_array_equal(raster_to_slots(slots, dims, q).numpy(),
                                  np.asarray(j_to_slots(raster, dims, q)))


def test_plain_terms_match_kernel_and_reference(office):
    xi = np.array([0.08, -0.05, 0.03, 0.02, -0.01, 0.03], np.float32)
    src = _source(office, xi)
    jsr, jtr, slots, table = _both_rasters(src, office, np.eye(4), ORIGIN,
                                           DIMS, 8, 8)
    T = np.asarray(jse3.exp(jnp.asarray(0.5 * xi)))
    got = icp_terms_plain(slots, table, _t(T), 1.0, 0.4, DIMS, 8, 8)
    kern = j_terms(jsr, jtr, jnp.asarray(T), 1.0, 0.4, DIMS, 8, 8,
                   interpret=True)
    ref = j_ref(jsr, jtr, jnp.asarray(T), 1.0, 0.4, DIMS, 8, 8)
    for want in (kern, ref):
        # the bar of tests/test_icp_raster.py (float32 sums in other
        # orders), and a tighter one: each output within 1e-6 of its own
        # largest magnitude (measured: at most 8e-8)
        for g, w, name in zip(got, want, NAMES):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-3,
                                       err_msg=name)
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), name
    # the kernel transforms element-wise in the same order: the same
    # matches (the reference's matmul transform may flip a gate-edge slot)
    assert float(got[3]) == float(kern[3])
    assert abs(float(got[3]) - float(ref[3])) <= 2
    assert float(got[3]) > 0.5 * float(office[1].sum())


def _tie_case():
    """Three source points, each with two equally near target points: in
    neighbour cells dx = -1 and +1, in two slots of one cell (the second
    listed first, so it holds slot 0), in neighbour cells dy = -1 and
    dz = -1. The first in (dx, dy, dz, slot) order must win."""
    src = np.array([[1.25, 1.25, 1.25], [2.75, 2.75, 2.75],
                    [1.25, 3.25, 1.25]], np.float32)
    tgt = np.array([[1.75, 1.25, 1.25], [0.75, 1.25, 1.25],
                    [2.75, 2.625, 2.75], [2.875, 2.75, 2.75],
                    [1.25, 3.25, 0.75], [1.25, 2.75, 1.25]], np.float32)
    want_r = np.array([[0.5, 0.0, 0.0], [0.0, 0.125, 0.0],
                       [0.0, 0.5, 0.0]], np.float32)
    return src, tgt, want_r


def test_ties_pick_the_reference_target():
    dims, q = (8, 8, 8), 4
    src, tgt, want_r = _tie_case()
    origin = np.zeros(3, np.float32)
    eye = np.eye(4, dtype=np.float32)
    s = (src, np.ones(len(src), bool))
    t = (tgt, np.ones(len(tgt), bool))
    jsr, jtr, slots, table = _both_rasters(s, t, eye, origin, dims, q, q)
    got = icp_terms_plain(slots, table, _t(eye), 1.0, 0.5, dims, q, q)
    kern = j_terms(jsr, jtr, jnp.asarray(eye), 1.0, 0.5, dims, q, q,
                   interpret=True)
    ref = j_ref(jsr, jtr, jnp.asarray(eye), 1.0, 0.5, dims, q, q)
    # d <= delta everywhere, so w = 1 and b[:3] is the sum of the residuals
    # T p - q of the chosen targets: exact binary fractions
    np.testing.assert_array_equal(got[1][:3].numpy(), want_r.sum(axis=0))
    for want in (kern, ref):
        for g, w, name in zip(got, want, NAMES):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    # and each point alone
    for k in range(len(src)):
        one = (src[k:k + 1], np.ones(1, bool))
        _, _, slots, table = _both_rasters(one, t, eye, origin, dims, q, q)
        H, b, err, nmatch, wsum = icp_terms_plain(slots, table, _t(eye), 1.0,
                                                  0.5, dims, q, q)
        np.testing.assert_array_equal(b[:3].numpy(), want_r[k])
        assert float(nmatch) == 1.0 and float(wsum) == 1.0


@pytest.mark.parametrize("perm", [None, (2, 0, 1)])
def test_icp_raster_matches_reference(office, perm):
    xi = np.array([0.1, -0.06, 0.03, 0.015, -0.01, 0.02], np.float32)
    src = _source(office, xi)
    # tests/test_icp_raster.py's solve: world z on window x when permuted
    dims, origin = (DIMS, ORIGIN) if perm is None else (
        (8, 16, 16), np.array([-2.0, -4.0, -4.0], np.float32))
    kw = dict(max_iterations=20, max_corr_dist=1.0, huber_delta=0.4)
    ref = j_icp_raster(JCloud(points=jnp.asarray(src[0]),
                              mask=jnp.asarray(src[1])),
                       JCloud(points=jnp.asarray(office[0]),
                              mask=jnp.asarray(office[1])),
                       params=JParams(**kw), dims=dims, leaf=LEAF,
                       origin_world=jnp.asarray(origin), interpret=True,
                       axis_perm=perm)
    pair = (PointCloud(points=_t(src[0]), mask=_t(src[1], torch.bool)),
            PointCloud(points=_t(office[0]), mask=_t(office[1], torch.bool)))
    port_kw = dict(params=ICPParams(**kw), dims=dims, leaf=LEAF,
                   origin_world=_t(origin), axis_perm=perm)
    before = icp_terms_plain.launches
    host = icp_raster(*pair, compiled=False, **port_kw)
    # one terms pass an iteration in the host-exit form
    assert icp_terms_plain.launches - before == int(host.iterations)
    # the default, the compiled program's sync-free form, gives its bits
    res = icp_raster(*pair, **port_kw)
    for f in ("T", "iterations", "error", "matched_fraction", "converged"):
        assert torch.equal(getattr(res, f), getattr(host, f)), f
    assert int(res.iterations) == int(ref.iterations)
    # float32 sums and 6x6 solves in other orders over 7 iterations
    # (measured: T within 9e-8, the error within 2e-7 relative, the same
    # matches)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-6)
    n_valid = float(src[1].sum())
    assert abs(float(res.matched_fraction)
               - float(ref.matched_fraction)) <= 1.0 / n_valid + 1e-7
    np.testing.assert_allclose(float(res.error), float(ref.error), rtol=1e-5)
    assert bool(res.converged) == bool(ref.converged)
    err = np.linalg.norm(np.asarray(jse3.log(
        jse3.inverse(jse3.exp(jnp.asarray(xi))) @ jnp.asarray(res.T.numpy()))))
    assert err < 0.06, err


def test_default_origin_is_the_reference_formula(office):
    tgt = PointCloud(points=_t(office[0]), mask=_t(office[1], torch.bool))
    prob = raster_problem(tgt, tgt, None, DIMS, LEAF, 8)
    # tpu_slam/registration/icp.py:196-201, on the same points
    p, m = jnp.asarray(office[0]), jnp.asarray(office[1])
    cen = (jnp.sum(jnp.where(m[:, None], p, 0.0), axis=0)
           / jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0))
    half = jnp.asarray([d * LEAF / 2 for d in DIMS], jnp.float32)
    want = jnp.round((cen - half) / LEAF) * LEAF
    np.testing.assert_array_equal(prob.origin.numpy(), np.asarray(want))
    assert torch.equal(prob.init_T, torch.eye(4)) and prob.perm is None


def test_icp_auto_routes_by_capacity(office):
    src = _source(office, np.array([0.05, 0.0, 0.0, 0.0, 0.0, 0.01],
                                   np.float32))
    s = PointCloud(points=_t(src[0]), mask=_t(src[1], torch.bool))
    t = PointCloud(points=_t(office[0]), mask=_t(office[1], torch.bool))
    params = ICPParams(max_iterations=2, max_corr_dist=1.0)
    kw = dict(dims=DIMS, leaf=LEAF, origin_world=_t(ORIGIN))
    for crossover, tier in ((4097, "brute"), (4096, "raster")):
        nn0, terms0 = nearest_neighbors_plain.launches, \
            icp_terms_plain.launches
        icp_auto(s, t, params=params, crossover=crossover, **kw)
        ran_nn = nearest_neighbors_plain.launches > nn0
        ran_terms = icp_terms_plain.launches > terms0
        assert (ran_nn, ran_terms) == (tier == "brute", tier == "raster")


def test_wrapper_dispatch_and_checks(office):
    xi = np.array([0.02, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    _, _, slots, table = _both_rasters(_source(office, xi), office,
                                       np.eye(4), ORIGIN, DIMS, 8, 8)
    before = (icp_terms_plain.launches, icp_terms_raster.launches)
    out = icp_terms_raster(slots, table, torch.eye(4), 1.0, 0.4, DIMS, 8, 8)
    ref = icp_terms_plain(slots, table, torch.eye(4), 1.0, 0.4, DIMS, 8, 8)
    # the CPU wrapper is the plain version; no kernel launch is counted
    assert (icp_terms_plain.launches, icp_terms_raster.launches) == \
        (before[0] + 2, before[1])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        icp_terms_raster(slots, table[:-1], torch.eye(4), 1.0, 0.4, DIMS, 8,
                         8)
    with pytest.raises(ValueError):
        icp_terms_raster(slots, table.double(), torch.eye(4), 1.0, 0.4, DIMS,
                         8, 8)
    with pytest.raises(TypeError):
        icp_terms_raster(slots, table, torch.eye(4), torch.tensor(1.0), 0.4,
                         DIMS, 8, 8)
    # the gate squares the float32 distance, as the reference's kernel does
    assert icp_terms._gate_constants(0.1, 0.3)[0] == float(
        np.float32(0.1) * np.float32(0.1))


def test_slope_time_on_the_cpu_and_no_silent_fallback(monkeypatch):
    x = torch.zeros(64)

    def loop(k):
        y = x
        for _ in range(k):
            y = torch.sin(y + 1.0)
        return y

    assert slope_time(loop, 2, 10, device="cpu") > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        slope_time(loop, 2, 10)
