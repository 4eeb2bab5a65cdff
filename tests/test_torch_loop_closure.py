"""The port's loop-closure front end against tpu_slam's (CPU).

Normals, scan-context descriptors and distances, proximity and
scan-context candidates, and the batched symmetric ICP verification
(plane and point branches), on the same office keyframes.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.graph import loop_closure as jlc
from tpu_slam.graph import scan_context as jsc
from tpu_slam.registration.icp import ICPParams as JICPParams
from tpu_slam.registration.normals import estimate_normals as jnormals
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph import loop_closure as lc
from tpu_slam_torch.graph import scan_context as sc
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.registration.icp import ICPParams
from tpu_slam_torch.registration.normals import estimate_normals

P = 1024
K = 8


@pytest.fixture(scope="module")
def keyframes():
    """K office keyframes on a circle (body frame, P rows, padded), their
    true poses, and noisy pose estimates; normals from the reference."""
    world = syn.default_office()
    rng = np.random.default_rng(0)
    pts, msk, gt = [], [], []
    for k in range(K):
        a = 2 * math.pi * k / K
        T = syn.se2_pose(2.0 * math.cos(a), 2.0 * math.sin(a),
                         a + math.pi / 2, z=1.2)
        p, v = syn.simulate_vlp16_revolution(world, T, n_azimuth=200,
                                             noise_std=0.005, rng=rng)
        p = p[v]
        p = p[rng.choice(len(p), min(len(p), P - 40 - 7 * k), replace=False)]
        out = np.full((P, 3), 1e8, np.float32)
        out[:len(p)] = p
        m = np.zeros(P, bool)
        m[:len(p)] = True
        pts.append(out)
        msk.append(m)
        gt.append(T)
    pts, msk, gt = np.stack(pts), np.stack(msk), np.stack(gt)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (K, 3))
    est = est.astype(np.float32)
    nrm = np.stack([np.array(jnormals(jnp.asarray(p), jnp.asarray(m)))
                    for p, m in zip(pts, msk)])
    return dict(pts=pts, msk=msk, gt=gt, est=est, nrm=nrm)


def _planar_points(p, m, k=16, ratio=0.3):
    """Valid points whose k-NN covariance (float64) has a smallest
    eigenvalue well separated from the middle one: only there is the
    normal defined up to float32 rounding and top-k ties."""
    q = p[m].astype(np.float64)
    d = ((q[:, None] - q[None]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1)[:, :k]
    nb = q[idx]
    c = nb - nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("pki,pkj->pij", c, c) / k)
    out = np.zeros(len(p), bool)
    out[np.nonzero(m)[0]] = ev[:, 0] < ratio * ev[:, 1]
    return out


def test_normals_match_reference_up_to_sign(keyframes):
    for k in range(3):
        p, m = keyframes["pts"][k], keyframes["msk"][k]
        got = estimate_normals(torch.as_tensor(p), torch.as_tensor(m)).numpy()
        ref = keyframes["nrm"][k]
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)
        sel = _planar_points(p, m)
        assert sel.sum() > 0.5 * m.sum()
        cos = np.abs((got[sel] * ref[sel]).sum(1))
        # the sign of a normal is arbitrary; 99% of well-defined normals
        # within 2.6 degrees (top-k ties may pick another neighbour)
        assert np.mean(cos >= 0.999) >= 0.99, np.mean(cos >= 0.999)
        np.testing.assert_array_equal(got[~m], np.tile([0, 0, 1], ((~m).sum(),
                                                                  1)))


@pytest.mark.parametrize("weight", [0.0, 0.5])
def test_scan_context_matches_reference(keyframes, weight):
    params = sc.ScanContextParams(intensity_weight=weight)
    jparams = jsc.ScanContextParams(intensity_weight=weight)
    rng = np.random.default_rng(1)
    for k in range(K):
        p, m = keyframes["pts"][k], keyframes["msk"][k]
        inten = rng.uniform(0, 2, (P, 1)).astype(np.float32)
        got = sc.scan_context(PointCloud(points=torch.as_tensor(p),
                                         mask=torch.as_tensor(m),
                                         attrs=torch.as_tensor(inten)),
                              params).numpy()
        ref = np.asarray(jsc.scan_context(
            JCloud(points=jnp.asarray(p), mask=jnp.asarray(m),
                   attrs=jnp.asarray(inten)), jparams))
        assert got.shape == (16, 60)
        # a point on a ring/sector boundary may land in the neighbour bin
        # after a last-bit atan2/division difference: 99.5% of bins equal
        assert np.mean(got == ref) >= 0.995
        # a mean of 60 flags: float32 division in another order
        np.testing.assert_allclose(sc.ring_key(torch.as_tensor(ref)).numpy(),
                                   np.asarray(jsc.ring_key(jnp.asarray(ref))),
                                   atol=1e-7)


def _descs(keyframes):
    return np.stack([np.asarray(jsc.scan_context(JCloud(
        points=jnp.asarray(p), mask=jnp.asarray(m))))
        for p, m in zip(keyframes["pts"], keyframes["msk"])])


def test_sc_distance_and_candidates_match_reference(keyframes):
    db = _descs(keyframes)
    db = np.concatenate([db, np.zeros((4,) + db.shape[1:], np.float32)])
    for q in (0, 5, K - 1):
        got = sc.sc_distance(torch.as_tensor(db[q]),
                             torch.as_tensor(db)).numpy()
        ref = np.asarray(jsc.sc_distance(jnp.asarray(db[q]),
                                         jnp.asarray(db)))
        # one float32 contraction in another order
        np.testing.assert_allclose(got, ref, atol=1e-5)
    for q, gap, dmax in ((K - 1, 3, 0.5), (K - 1, 2, 0.3), (5, 2, 1.0),
                         (2, 3, 1.0)):
        got = sc.propose_sc_candidates(torch.as_tensor(db[q]),
                                       torch.as_tensor(db), q, K, dmax, gap,
                                       top_k=3)
        ref = jsc.propose_sc_candidates(jnp.asarray(db[q]), jnp.asarray(db),
                                        q, K, dmax, gap, top_k=3)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32


@pytest.mark.parametrize("n_nodes", [5, 20, 30])
def test_propose_candidates_matches_reference(n_nodes):
    rng = np.random.default_rng(n_nodes)
    pos = np.cumsum(rng.normal(0, 0.4, (32, 3)), axis=0).astype(np.float32)
    pos[20:] = pos[:12] + rng.normal(0, 0.3, (12, 3))   # revisits
    params = lc.LoopClosureParams(max_distance=1.5, min_index_gap=4,
                                  max_candidates=6)
    jparams = jlc.LoopClosureParams(max_distance=1.5, min_index_gap=4,
                                    max_candidates=6)
    got = lc.propose_candidates(torch.as_tensor(pos), n_nodes, params)
    ref = jlc.propose_candidates(jnp.asarray(pos), n_nodes, jparams)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


@pytest.mark.parametrize("plane", [True, False])
def test_verify_candidates_matches_reference(keyframes, plane):
    kw = dict(max_distance=3.0, min_index_gap=1, max_candidates=6,
              min_matched_fraction=0.6, max_error=0.05 if plane else 0.25,
              plane_verify=plane, symmetric_verify=True)
    icp_kw = dict(max_iterations=20, tolerance=1e-4, max_corr_dist=1.0,
                  huber_delta=0.3)
    params = lc.LoopClosureParams(icp=ICPParams(**icp_kw), **kw)
    jparams = jlc.LoopClosureParams(icp=JICPParams(nn_impl="xla", **icp_kw),
                                    **kw)
    ci = np.array([0, 1, 2, 3, 0, 4], np.int32)
    cj = np.array([1, 2, 3, 4, 4, 5], np.int32)   # (0, 4): opposite sides
    est = keyframes["est"].copy()
    est[5, :3, 3] += [0.9, -0.6, 0.0]             # a far-off estimate
    t = torch.as_tensor
    res, accept = lc.verify_candidates(
        t(keyframes["pts"]), t(keyframes["msk"]), t(est), ci, cj, params,
        clouds_normals=t(keyframes["nrm"]) if plane else None)
    jres, jaccept = jlc.verify_candidates(
        jnp.asarray(keyframes["pts"]), jnp.asarray(keyframes["msk"]),
        jnp.asarray(est), ci, cj, jparams,
        clouds_normals=jnp.asarray(keyframes["nrm"]) if plane else None)
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jaccept))
    assert 0 < int(accept.sum()) < len(ci)         # both outcomes occur
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)
    # an accepted edge is the true relative pose within a few cm (point-
    # to-point residuals carry the ring-spacing bias: 6 cm measured)
    for k in np.nonzero(accept.numpy())[0]:
        true = np.linalg.inv(keyframes["gt"][ci[k]]) @ keyframes["gt"][cj[k]]
        err = np.abs(res.T[k].numpy()[:3, 3] - true[:3, 3]).max()
        assert err < (0.05 if plane else 0.1)


def test_params_carry_the_reference_fields():
    ref = dataclasses.asdict(jlc.LoopClosureParams())
    got = dataclasses.asdict(lc.LoopClosureParams())
    assert got == ref
