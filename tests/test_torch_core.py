"""tpu_slam_torch.core against tpu_slam.core on the same inputs (CPU).

SE(3) maps, the floored NDT information closed form and the padded point
cloud operations; inputs come from a numpy seed and go through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.core.sym3 import floored_info_sym3_tri as j_floored
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.core.sym3 import floored_info_sym3_tri

# float32 on both sides; the two evaluate the same formulas but their
# transcendentals and 3x3 products round differently in the last bits
ATOL = 2e-6


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _xis():
    rng = np.random.default_rng(0)
    xs = [rng.normal(0, s, 6) for s in (0.5, 0.1, 1e-3)]
    xs.append(np.array([0.3, -0.2, 0.1, 1e-7, -2e-7, 5e-8]))   # theta2<1e-12
    xs.append(np.array([0.1, 0.2, 0.3, 2e-5, 1e-5, -3e-5]))    # theta<1e-4
    axis = rng.normal(0, 1, 3)
    axis /= np.linalg.norm(axis)
    xs.append(np.concatenate([[0.5, -1.0, 2.0], axis * (np.pi - 5e-4)]))
    xs.append(np.concatenate([[0.0, 0.0, 0.0], axis * (np.pi - 0.01)]))
    return [x.astype(np.float32) for x in xs]


@pytest.mark.parametrize("k", range(7))
def test_exp_log_match_reference(k):
    xi = _xis()[k]
    T_ref = np.asarray(jse3.exp(jnp.asarray(xi)))
    T = se3.exp(_t(xi)).numpy()
    np.testing.assert_allclose(T, T_ref, atol=ATOL)
    # log: near pi the angle comes from arccos of the trace, whose slope
    # there amplifies a last-bit trace difference to ~1e-3 rad * 1e-4
    tol = 5e-4 if k >= 5 else 1e-5
    np.testing.assert_allclose(se3.log(_t(T_ref)).numpy(),
                               np.asarray(jse3.log(jnp.asarray(T_ref))),
                               atol=tol)


def test_inverse_retract_orthonormalize_match_reference():
    rng = np.random.default_rng(1)
    for xi in _xis()[:4]:
        T = np.asarray(jse3.exp(jnp.asarray(xi)))
        d = rng.normal(0, 0.05, 6).astype(np.float32)
        np.testing.assert_allclose(se3.inverse(_t(T)).numpy(),
                                   np.asarray(jse3.inverse(jnp.asarray(T))),
                                   atol=ATOL)
        np.testing.assert_allclose(
            se3.retract(_t(T), _t(d)).numpy(),
            np.asarray(jse3.retract(jnp.asarray(T), jnp.asarray(d))),
            atol=ATOL)
        # a rotation with 1e-3 scale/skew, pulled back onto SO(3)
        Tn = T.copy()
        Tn[:3, :3] += rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
        ref = np.asarray(jse3.orthonormalize(jnp.asarray(Tn)))
        got = se3.orthonormalize(_t(Tn)).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL)
        # one polar-Newton step leaves a second-order residual: (1e-3)^2
        # times a small constant
        R = got[:3, :3]
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=5e-5)


def _covariances():
    rng = np.random.default_rng(2)
    a = rng.normal(0, 0.3, (64, 3, 3))
    cov = a @ a.transpose(0, 2, 1)                      # generic SPD
    n = rng.normal(0, 1, (16, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    planar = 0.05 * (np.eye(3) - n[:, :, None] * n[:, None, :])
    line = 0.04 * n[:, :, None] * n[:, None, :]         # rank 1
    iso = np.repeat(0.02 * np.eye(3)[None], 4, axis=0)  # repeated eigvals
    zero = np.zeros((2, 3, 3))                          # empty cell
    return np.concatenate([cov, planar, line, iso, zero]).astype(np.float32)


def test_floored_info_matches_reference():
    cov = _covariances()
    iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    ref = j_floored(tuple(jnp.asarray(cov[:, i, j]) for i, j in iu), 0.01)
    got = floored_info_sym3_tri(tuple(_t(cov[:, i, j]) for i, j in iu), 0.01)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        # the information entries reach 1/(0.01*lambda_max); compare
        # relative to each matrix's scale (float32 cancellation in the
        # divided differences)
        scale = np.maximum(np.abs(r), 1.0)
        assert np.all(np.abs(g.numpy() - r) <= 1e-4 * scale)


def test_pointcloud_compact_transform_match_reference():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    mask = rng.uniform(size=40) < 0.6
    T = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.3, 6)
                                        .astype(np.float32))))
    jc = JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask))
    tc = PointCloud(points=_t(pts), mask=torch.as_tensor(mask))
    jcc, tcc = jc.compact(), tc.compact()
    np.testing.assert_array_equal(tcc.points.numpy(), np.asarray(jcc.points))
    np.testing.assert_array_equal(tcc.mask.numpy(), np.asarray(jcc.mask))
    jt, tt = jc.transform(jnp.asarray(T)), tc.transform(_t(T))
    np.testing.assert_allclose(tt.points.numpy(), np.asarray(jt.points),
                               atol=1e-5)
    assert np.all(tt.points.numpy()[~mask] == 1e8)
    host = PointCloud.from_points_host(pts[mask], capacity=48, device="cpu")
    jhost = JCloud.from_points_host(pts[mask], capacity=48)
    np.testing.assert_array_equal(host.points.numpy(),
                                  np.asarray(jhost.points))
    assert int(host.count()) == int(mask.sum())
