"""The port's ICP and robust weights against tpu_slam's (CPU).

Point-to-point and point-to-plane, one pair and a batch of pairs, against
the reference ``icp`` (NN on its XLA tier) and ``jax.vmap(icp)``, on the
same office scans and the same target normals; plus the zero-inlier case.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.registration import robust as jrobust
from tpu_slam.registration.icp import ICPParams as JParams
from tpu_slam.registration.icp import icp as jicp
from tpu_slam.registration.normals import estimate_normals as jnormals
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.registration import robust
from tpu_slam_torch.registration.icp import ICPParams, icp

CAP = 768


def _scan(world, T, rng, n_keep=700):
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=200,
                                               noise_std=0.005, rng=rng)
    pts = pts[valid]
    pts = pts[rng.choice(len(pts), n_keep, replace=False)]
    out = np.full((CAP, 3), 1e8, np.float32)
    out[:n_keep] = pts
    mask = np.zeros(CAP, bool)
    mask[:n_keep] = True
    return out, mask


@pytest.fixture(scope="module")
def pairs():
    """Three (source, target) office scan pairs with target normals and a
    perturbed initial guess of the true source->target transform."""
    world = syn.default_office()
    rng = np.random.default_rng(0)
    out = []
    for k in range(3):
        Tt = syn.se2_pose(0.2 * k, -0.1 * k, 0.1 * k, z=1.2)
        Ts = syn.se2_pose(0.2 * k + 0.3, -0.1 * k + 0.1, 0.1 * k + 0.05,
                          z=1.2)
        sp, sm = _scan(world, Ts, rng, 700 - 30 * k)
        tp, tm = _scan(world, Tt, rng, 720)
        tn = np.array(jnormals(jnp.asarray(tp), jnp.asarray(tm)))
        true = np.linalg.inv(Tt) @ Ts
        xi = rng.normal(0, [0.05] * 3 + [0.02] * 3).astype(np.float32)
        init = (np.asarray(jse3.exp(jnp.asarray(xi)))
                @ true).astype(np.float32)
        out.append(dict(sp=sp, sm=sm, tp=tp, tm=tm, tn=tn, init=init))
    return out


def _params(plane):
    kw = dict(max_iterations=25, tolerance=1e-4, max_corr_dist=1.0,
              huber_delta=0.3, point_to_plane=plane)
    return JParams(nn_impl="xla", **kw), ICPParams(**kw)


def _run_port(ps, plane, batched):
    _, params = _params(plane)
    t = lambda k: torch.as_tensor(np.stack([p[k] for p in ps]))  # noqa: E731
    if batched:
        return icp(PointCloud(points=t("sp"), mask=t("sm")),
                   PointCloud(points=t("tp"), mask=t("tm")),
                   init_T=t("init"), params=params,
                   target_normals=t("tn") if plane else None)
    return [icp(PointCloud(points=torch.as_tensor(p["sp"]),
                           mask=torch.as_tensor(p["sm"])),
                PointCloud(points=torch.as_tensor(p["tp"]),
                           mask=torch.as_tensor(p["tm"])),
                init_T=torch.as_tensor(p["init"]), params=params,
                target_normals=torch.as_tensor(p["tn"]) if plane else None)
            for p in ps]


def _run_reference(ps, plane):
    jparams, _ = _params(plane)

    def one(sp, sm, tp, tm, tn, T0):
        return jicp(JCloud(points=sp, mask=sm), JCloud(points=tp, mask=tm),
                    init_T=T0, params=jparams,
                    target_normals=tn if plane else None)

    a = lambda k: jnp.asarray(np.stack([p[k] for p in ps]))  # noqa: E731
    return jax.vmap(one)(a("sp"), a("sm"), a("tp"), a("tm"), a("tn"),
                         a("init"))


@pytest.mark.parametrize("plane", [False, True])
def test_icp_matches_reference_and_batch_matches_single(pairs, plane):
    ref = _run_reference(pairs, plane)
    res = _run_port(pairs, plane, batched=True)
    singles = _run_port(pairs, plane, batched=False)
    for k, one in enumerate(singles):
        # the batch freezes a finished pair: each pair stops at its own
        # iteration count with its own inlier count and convergence flag.
        # The (B, N) einsums sum a pair's points in another order than the
        # (1, N) ones (measured: T differs in the last bit, ~1e-7), so the
        # floats are held to 1e-6 and the integers exactly
        for f in ("iterations", "matched_fraction", "converged"):
            assert torch.equal(getattr(res, f)[k], getattr(one, f)), f
        np.testing.assert_allclose(res.T[k].numpy(), one.T.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(float(res.error[k]), float(one.error),
                                   rtol=1e-5)
    n_valid = np.array([p["sm"].sum() for p in pairs])
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    # float32 NN distances and 6x6 solves rounded in another order: the
    # same correspondences, poses within 1e-4, the matched fraction within
    # one point, the error within 1e-3 relative
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-4)
    assert np.all(np.abs(res.matched_fraction.numpy()
                         - np.asarray(ref.matched_fraction))
                  <= 1.0 / n_valid + 1e-7)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error),
                               rtol=1e-3)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    assert res.matched_fraction.min() > 0.8


@pytest.mark.parametrize("plane", [False, True])
def test_zero_inliers_give_a_zero_step(pairs, plane):
    p = dict(pairs[0])
    p["init"] = p["init"].copy()
    p["init"][:3, 3] += 50.0                # far beyond max_corr_dist
    ref = _run_reference([p], plane)
    res = _run_port([p], plane, batched=True)
    np.testing.assert_array_equal(res.T.numpy(), np.asarray(ref.T))
    np.testing.assert_array_equal(res.T.numpy()[0], p["init"])
    assert int(res.iterations[0]) == int(ref.iterations[0]) == 1
    assert float(res.matched_fraction[0]) == 0.0
    assert bool(res.converged[0])


def test_robust_weights_match_reference():
    r = np.random.default_rng(3).normal(0, 1.0, 200).astype(np.float32)
    r[:3] = [0.0, 0.3, -0.3]
    for name, c in (("huber_weight", 0.3), ("tukey_weight", 0.8),
                    ("cauchy_weight", 0.5)):
        got = getattr(robust, name)(torch.as_tensor(r), c).numpy()
        ref = np.asarray(getattr(jrobust, name)(jnp.asarray(r), c))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_point_to_plane_needs_normals(pairs):
    p = pairs[0]
    with pytest.raises(ValueError):
        icp(PointCloud(points=torch.as_tensor(p["sp"]),
                       mask=torch.as_tensor(p["sm"])),
            PointCloud(points=torch.as_tensor(p["tp"]),
                       mask=torch.as_tensor(p["tm"])),
            params=ICPParams(point_to_plane=True))
    assert math.isfinite(float(p["init"][0, 3]))
