"""The port's pose graph against tpu_slam's (CPU).

The same noisy circle graph (numpy seed) is built in both packages:
residuals and Jacobians, the matrix-free H v against a dense H, the PCG and
dense GN steps, full optimizations with Huber, Cauchy, annealing and
trusted loops (a wrong loop edge included), the host helpers, and a
scatter with repeated indices.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.graph import pose_graph as jpg
from tpu_slam_torch.core import se3
from tpu_slam_torch.graph import pose_graph as pg

N, CAP_N, CAP_E = 24, 32, 64


def _exp(xi):
    return se3.exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()


def _circle(seed=0, drift=0.02, bad_loop=False):
    """(poses, edges, gt): initial poses from noisy odometry, edges
    (i, j, Z, info) with a true loop (0, N-1) and optionally a gross wrong
    loop (3, 18)."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(N):
        a = 2 * math.pi * k / N
        c, s = math.cos(a), math.sin(a)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [3.0 * c, 3.0 * s, 0.1 * math.sin(3 * a)]
        gt.append(T)
    est, edges = [gt[0]], []
    for k in range(N - 1):
        Z = np.linalg.inv(gt[k]) @ gt[k + 1]
        Zn = (_exp(rng.normal(0, drift, 6)) @ Z).astype(np.float32)
        edges.append((k, k + 1, Zn, 100.0 * np.eye(6, dtype=np.float32)))
        est.append((est[-1] @ Zn).astype(np.float32))
    edges.append((0, N - 1, (np.linalg.inv(gt[0]) @ gt[N - 1])
                  .astype(np.float32), 10.0 * np.eye(6, dtype=np.float32)))
    if bad_loop:
        Zb = (_exp([1.5, -1.0, 0.5, 0.3, 0.2, 0.6])
              @ (np.linalg.inv(gt[3]) @ gt[18])).astype(np.float32)
        edges.append((3, 18, Zb, 25.0 * np.eye(6, dtype=np.float32)))
    return np.stack(est), edges, np.stack(gt)


def _graphs(poses, edges):
    """The same graph as a reference PoseGraph and a port PoseGraph."""
    jg = jpg.empty_graph(CAP_N, CAP_E)
    tg = pg.empty_graph(CAP_N, CAP_E, device="cpu")
    for T in poses:
        jg, _ = jpg.add_node(jg, jnp.asarray(T))
        tg, _ = pg.add_node(tg, torch.as_tensor(T))
    for i, j, Z, info in edges:
        jg = jpg.add_edge(jg, i, j, jnp.asarray(Z), jnp.asarray(info))
        tg = pg.add_edge(tg, i, j, torch.as_tensor(Z), torch.as_tensor(info))
    return jg, tg


def test_residuals_and_jacobians_match_reference():
    poses, edges, _ = _circle(bad_loop=True)
    jg, tg = _graphs(poses, edges)
    jr, jJ, jinfo = jpg._gather_edge_terms(jg)
    r, J, info = pg._gather_edge_terms(tg)
    # float32 log/exp of the same matrices (see test_torch_core)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=2e-5)
    np.testing.assert_array_equal(info.numpy(), np.asarray(jinfo))


def _dense_H(tg, params):
    """H = sum_e J_e^T W_e J_e + prior + damping, in float64 numpy."""
    _, J, info = (x.double().numpy() for x in pg._gather_edge_terms(tg))
    n = tg.node_capacity
    H = np.zeros((6 * n, 6 * n))
    ei, ej = tg.edge_i.numpy(), tg.edge_j.numpy()
    for e in range(len(ei)):
        JtWJ = J[e].T @ info[e] @ J[e]
        for a, b, s in ((ei[e], ei[e], 1), (ej[e], ej[e], 1),
                        (ei[e], ej[e], -1), (ej[e], ei[e], -1)):
            H[6 * a:6 * a + 6, 6 * b:6 * b + 6] += s * JtWJ
    H[:6, :6] += params.prior_weight * np.eye(6)
    return H + params.damping * np.eye(6 * n)


def test_hv_matches_dense_H():
    poses, edges, _ = _circle()
    _, tg = _graphs(poses, edges)
    params = pg.GraphSolveParams()
    v = np.random.default_rng(1).normal(0, 1, (CAP_N, 6)).astype(np.float32)
    _, _, terms = pg._build_rhs_and_diag(tg, params)
    got = pg._hv(tg, params, terms, torch.as_tensor(v)).numpy()
    ref = _dense_H(tg, params) @ v.reshape(-1).astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got.reshape(-1) - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_gn_step_solves_match_reference(solver):
    poses, edges, _ = _circle()
    jg, tg = _graphs(poses, edges)
    jp = jpg.GraphSolveParams(solver=solver, cg_iterations=50)
    tp = pg.GraphSolveParams(solver=solver, cg_iterations=50)
    jb, jdiag, jterms = jpg._build_rhs_and_diag(jg, jp)
    b, diag, terms = pg._build_rhs_and_diag(tg, tp)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(diag.numpy(), np.asarray(jdiag), rtol=1e-5,
                               atol=1e-2)
    jsolve = jpg._solve_dense if solver == "dense" else jpg._solve_pcg
    tsolve = pg._solve_dense if solver == "dense" else pg._solve_pcg
    jx = np.asarray(jsolve(jg, jp, jb, jdiag, jterms))
    x = tsolve(tg, tp, b, diag, terms).numpy()
    # one GN step's increments (up to ~0.3); float32 CG and LU on
    # right-hand sides that agree to 1e-4 relative
    np.testing.assert_allclose(x, jx, atol=2e-4)
    if solver == "dense":
        # the dense solve is exact: it satisfies H x = b
        H = _dense_H(tg, tp)
        res = H @ x.reshape(-1).astype(np.float64) - b.double().numpy() \
            .reshape(-1)
        assert np.abs(res).max() <= 1e-3 * np.abs(b.numpy()).max()


OPT_CASES = {
    "plain": dict(gn_iterations=8),
    "huber": dict(gn_iterations=8, robust_delta=0.5, robust_kernel="huber"),
    "cauchy": dict(gn_iterations=12, robust_delta=0.3),
    "anneal": dict(gn_iterations=10, robust_delta=0.3, robust_anneal=8.0),
    "trust_loops": dict(gn_iterations=12, cg_iterations=200,
                        robust_delta=0.3, trust_loops=True),
    "dense": dict(gn_iterations=6, solver="dense", robust_delta=2.0),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
@pytest.mark.parametrize("bad_loop", [False, True])
def test_optimize_matches_reference(name, bad_loop):
    poses, edges, gt = _circle(seed=5, bad_loop=bad_loop)
    jg, tg = _graphs(poses, edges)
    kw = OPT_CASES[name]
    jout, jchi = jpg.optimize_pose_graph(jg, jpg.GraphSolveParams(**kw))
    out, chi = pg.optimize_pose_graph(tg, pg.GraphSolveParams(**kw))
    # the GN iterates of two float32 implementations: poses within 1e-4.
    # One case is looser: trust_loops exempts the WRONG loop from the
    # robust weight, so 12 GN steps of 200 float32 CG iterations each pull
    # against a 1.5 m inconsistency; the two sides' rounding then drifts to
    # 1.87e-4 m (measured), so that case is held to 3e-4
    atol = 3e-4 if (bad_loop and kw.get("trust_loops")) else 1e-4
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(jout.poses),
                               atol=atol)
    np.testing.assert_allclose(float(chi), float(jchi), rtol=1e-3,
                               atol=1e-3)
    assert out.n_nodes == N
    # padding nodes stay frozen at identity
    np.testing.assert_array_equal(out.poses[N:].numpy(),
                                  np.broadcast_to(np.eye(4), (CAP_N - N, 4,
                                                              4)))


def test_robust_kernel_cuts_a_wrong_loop():
    poses, edges, gt = _circle(seed=5, bad_loop=True)
    _, tg = _graphs(poses, edges)

    def ate(g):
        d = g.poses[:N, :3, 3].numpy() - gt[:, :3, 3]
        return float(np.sqrt((d * d).sum(1).mean()))

    plain, _ = pg.optimize_pose_graph(tg, pg.GraphSolveParams(
        gn_iterations=12))
    robust, _ = pg.optimize_pose_graph(tg, pg.GraphSolveParams(
        gn_iterations=12, robust_delta=0.3))
    assert ate(robust) < 0.5 * ate(plain)


def test_host_helpers_match_reference():
    poses, edges, _ = _circle(bad_loop=True)
    jg, tg = _graphs(poses, edges)
    assert pg.n_edges(tg) == jpg.n_edges(jg) == len(edges)

    def same(t, j):
        assert t.n_nodes == int(j.n_nodes)
        for f in ("poses", "edge_i", "edge_j", "edge_T", "edge_info",
                  "edge_mask"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)

    same(tg, jg)
    for m in (1, 5, 17):
        same(pg.drop_node_prefix(tg, m), jpg.drop_node_prefix(jg, m))
    t2 = pg.add_edge(pg.drop_node_prefix(tg, 5), 0, 1,
                     torch.eye(4), None)
    j2 = jpg.add_edge(jpg.drop_node_prefix(jg, 5), 0, 1,
                      jnp.eye(4, dtype=jnp.float32))
    same(t2, j2)
    # the input graph is not modified by the helpers
    same(tg, jg)
    with pytest.raises(ValueError):
        pg.drop_node_prefix(tg, N)


def test_repeated_indices_sum_every_contribution():
    """Many edges share an endpoint: the rhs and the diagonal must sum all
    of them (a ``x[idx] += v`` scatter would keep one write per index)."""
    poses, edges, _ = _circle()
    extra = [(0, j, Z, info) for j in range(2, 12)
             for (_, _, Z, info) in [edges[j - 1]]]
    _, tg = _graphs(poses, edges + extra)
    params = pg.GraphSolveParams()
    b, diag, (r, J, info) = pg._build_rhs_and_diag(tg, params)
    r, J, info = (x.double().numpy() for x in (r, J, info))
    ref_b = np.zeros((CAP_N, 6))
    ref_d = np.zeros((CAP_N, 6, 6))
    for e, (i, j) in enumerate(zip(tg.edge_i.numpy(), tg.edge_j.numpy())):
        g = J[e].T @ info[e] @ r[e]
        ref_b[i] += g
        ref_b[j] -= g
        h = J[e].T @ info[e] @ J[e]
        ref_d[i] += h
        ref_d[j] += h
    ref_d[0] += params.prior_weight * np.eye(6)
    ref_d += params.damping * np.eye(6)
    np.testing.assert_allclose(b.numpy(), ref_b, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(diag.numpy(), ref_d, atol=1e-2, rtol=1e-5)
    # node 0 has 12 edges: its block holds all of them
    assert np.abs(ref_d[0] - params.prior_weight * np.eye(6)).max() > 1e3


def test_graph_is_a_dataclass_with_host_counts():
    g = pg.empty_graph(4, 8, device="cpu")
    assert g.n_nodes == 0 and pg.n_edges(g) == 0
    g2, k = pg.add_node(g, torch.eye(4))
    assert k == 0 and g2.n_nodes == 1 and g.n_nodes == 0
    assert dataclasses.is_dataclass(g2)
