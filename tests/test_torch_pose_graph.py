"""The port's pose graph against tpu_slam's (CPU).

The same noisy circle graph (numpy seed) is built in both packages:
residuals and Jacobians, the matrix-free H v against a dense H, the PCG and
dense GN steps, full optimizations with Huber, Cauchy, annealing and
trusted loops (a wrong loop edge included), the host helpers, and a
scatter with repeated indices. Then the port's own pieces of the CG chunk
kernel (``kernels/pcg.py``): each node's incidence list and its sum to
H v, the kernel's shared-memory plan, and its wrapper's checks.
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


def _incidence_graph(case):
    """The circle with its wrong loop, a live node with no edge, and for
    ``dropped`` the first 5 nodes dropped (its masked edges keep stale
    indices; a fresh graph's padding holds index 0)."""
    poses, edges, _ = _circle(bad_loop=True)
    _, g = _graphs(poses, edges)
    if case == "dropped":
        g = pg.drop_node_prefix(g, 5)
    g, _ = pg.add_node(g, g.poses[0])
    padding = g.edge_i[~g.edge_mask]
    assert bool((padding != 0).any()) == (case == "dropped")
    return g


@pytest.mark.parametrize("case", ["fresh", "dropped"])
def test_node_incidence_lists_live_edges_in_hv_order(case):
    g = _incidence_graph(case)
    ptr, entries = pg.node_incidence(g)
    assert ptr.dtype == entries.dtype == torch.int32
    assert ptr.shape == (g.node_capacity + 1,)
    assert entries.shape == (2 * g.edge_capacity,)
    ei, ej = g.edge_i.numpy(), g.edge_j.numpy()
    live = np.flatnonzero(g.edge_mask.numpy())
    ptr, entries = ptr.numpy(), entries.numpy()
    assert ptr[0] == 0 and ptr[-1] == 2 * len(live)
    for n in range(g.node_capacity):
        # its edge_i edges in edge order, then its edge_j edges
        want = ([2 * e for e in live if ei[e] == n]
                + [2 * e + 1 for e in live if ej[e] == n])
        assert entries[ptr[n]:ptr[n + 1]].tolist() == want, n
    # every live edge twice, once at each end; no masked edge
    listed = np.sort(entries[:ptr[-1]])
    np.testing.assert_array_equal(listed, np.sort(np.concatenate(
        [2 * live, 2 * live + 1])))
    # the live node without edges and every slot past the live nodes
    for n in range(g.n_nodes - 1, g.node_capacity):
        assert ptr[n] == ptr[n + 1], n


@pytest.mark.parametrize("case", ["fresh", "dropped"])
def test_node_incidence_sums_to_hv(case):
    """The chunk kernel's node-major H·v: each node's signed sum of the
    edge terms J_j^T W J_j (v_j - v_i) over its incidence list (a minus
    for an entry 2e, a plus for 2e + 1), with the gauge prior and the
    damping, is ``_hv`` (both in float64, so only the order of the sums
    differs)."""
    g = _incidence_graph(case)
    params = pg.GraphSolveParams()
    _, Jj, info = pg._build_rhs_and_diag(g, params)[2]
    Jj, info = Jj.double(), info.double()
    v = torch.as_tensor(np.random.default_rng(5).normal(
        0, 1, (g.node_capacity, 6)))
    u = torch.einsum("eab,eb->ea", Jj, v[g.edge_j] - v[g.edge_i])
    q = torch.einsum("eba,eb->ea", Jj, torch.einsum("eab,eb->ea", info, u))
    ptr, entries = (t.tolist() for t in pg.node_incidence(g))
    got = torch.zeros_like(v)
    for n in range(g.node_capacity):
        for c in entries[ptr[n]:ptr[n + 1]]:
            got[n] += q[c // 2] if c % 2 else -q[c // 2]
    got[0] += params.prior_weight * v[0]
    got += params.damping * v
    want = pg._hv(g, params, (None, Jj, info), v)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("caps, copied, fixed", [
    ((288, 1024), 491, 90_900), ((512, 2048), 215, 170_388),
    ((513, 64), None, None), ((1024, 4096), None, None)])
def test_pcg_chunk_smem_plan(caps, copied, fixed):
    """The chunk kernel's shared memory: c4's capacities and the default
    SLAMConfig's copy the matrices of their first 491 and 215 edge slots
    (an odd stride) within the 227 KB a block may use; more than 512 node
    slots, or a fixed part past the limit, raise ValueError."""
    from tpu_slam_torch.kernels.pcg import SMEM_LIMIT, smem_plan

    if copied is None:
        with pytest.raises(ValueError):
            smem_plan(*caps)
        return
    count, stride, nbytes = smem_plan(*caps)
    assert (count, stride) == (copied, copied)
    assert nbytes == fixed + 288 * stride <= SMEM_LIMIT
    assert nbytes + 288 * 2 > SMEM_LIMIT


@pytest.mark.parametrize("case", ["cpu", "float64"])
def test_pcg_chunk_takes_cuda_float32_only(case):
    """The chunk kernel's wrapper refuses CPU tensors and float64 ones
    with ValueError, before it builds anything (the CPU runs
    ``_pcg_iterations``)."""
    from tpu_slam_torch.kernels.pcg import pcg_chunk

    g = _incidence_graph("fresh")
    if case == "float64":
        g = dataclasses.replace(g, poses=g.poses.double(),
                                edge_T=g.edge_T.double(),
                                edge_info=g.edge_info.double())
    params = pg.GraphSolveParams()
    b, diag, terms = pg._build_rhs_and_diag(g, params)
    Minv, x, r, p, rz = pg._pcg_start(g, params, b, diag, terms)
    used = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA" if case == "cpu" else
                       "float32"):
        pcg_chunk(g.edge_i, g.edge_j, g.edge_mask, *pg.node_incidence(g),
                  terms[1], terms[2], Minv, x, r, p, rz, used,
                  params.prior_weight, params.damping, params.cg_tolerance,
                  16)
