"""The distributed pose-graph solvers (tpu_slam_torch.distributed.
pose_graph_dist, .schur) against tpu_slam.distributed's, on the CPU.

The same noisy circle graphs (tests/test_graph.py's, numpy-seeded) go to
the reference on the conftest's virtual CPU devices and to the port on
gloo ranks (one spawn per rank count for the module).

Tolerances: separators and slots exact; the edge-sharded PCG within 2e-3
of the poses and 1e-2 of chi^2 (relative) of the reference's sharded PCG
(the reference's bar against its dense solve), and within 1e-5 of the
port's single-device PCG; the Schur solve within 1e-4 and 1e-4 relative
of the reference's (its bars), the robust (Cauchy) case against the
reference's arrow solve and the port's single-device dense solve; every
rank's poses bit-identical.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.distributed.mesh import make_mesh
from tpu_slam.distributed.pose_graph_dist import \
    optimize_pose_graph_sharded as j_sharded
from tpu_slam.distributed.schur import optimize_pose_graph_schur as j_schur
from tpu_slam.distributed.schur import separator_mask as j_separator_mask
from tpu_slam.graph.pose_graph import GraphSolveParams as JParams
from tpu_slam.graph.pose_graph import add_edge as j_add_edge
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.distributed.schur import (_anneal_deltas,
                                              optimize_pose_graph_schur,
                                              separator_mask)
from tpu_slam_torch.graph.pose_graph import (GraphSolveParams,
                                             optimize_pose_graph)

from chip_smoke import _graph_torch
from tests import test_torch_dist_ranks as R
from tests.test_graph import _make_noisy_circle_graph

N = 24
PCG = dict(gn_iterations=6, cg_iterations=200, cg_tolerance=1e-12)
DENSE = dict(gn_iterations=6, solver="dense")
ROBUST = dict(gn_iterations=8, solver="dense", robust_delta=2.0,
              robust_kernel="cauchy")


def _numpy(g):
    return dict(poses=np.asarray(g.poses), n_nodes=int(g.n_nodes),
                edge_i=np.asarray(g.edge_i), edge_j=np.asarray(g.edge_j),
                edge_T=np.asarray(g.edge_T),
                edge_info=np.asarray(g.edge_info),
                edge_mask=np.asarray(g.edge_mask))


def _loopy(seed=5):
    """The reference's multi-loop case: loops at interior positions of
    several ranges."""
    g, gt = _make_noisy_circle_graph(np.random.default_rng(seed), n=N,
                                     node_cap=32, edge_cap=64)
    for (i, j) in [(3, 13), (6, 18), (9, 21)]:
        Z = jse3.inverse(gt[i]) @ gt[j]
        g = j_add_edge(g, i, j, Z, info=10.0 * jnp.eye(6, dtype=jnp.float32))
    return g


@pytest.fixture(scope="module")
def case():
    graphs = {
        "pcg": _make_noisy_circle_graph(np.random.default_rng(1),
                                        node_cap=32, edge_cap=64)[0],
        "schur": _make_noisy_circle_graph(np.random.default_rng(4),
                                          node_cap=32, edge_cap=64)[0],
        "robust": _loopy()}
    jobs = [("pcg", _numpy(graphs["pcg"]), "pcg", GraphSolveParams(**PCG)),
            ("schur", _numpy(graphs["schur"]), "schur",
             GraphSolveParams(**DENSE)),
            ("robust", _numpy(graphs["robust"]), "schur",
             GraphSolveParams(**ROBUST))]
    pool = ThreadPoolExecutor(2)
    port = {2: pool.submit(M.run_ranks, R.graph_body, 2, jobs,
                           device="cpu"),
            4: pool.submit(M.run_ranks, R.graph_body, 4, jobs,
                           device="cpu")}
    # the reference's sharded solves at two devices only (each is a long
    # XLA compile); the port's four ranks meet the same results at the
    # same bars. The robust case (Cauchy weights, annealed) meets the
    # reference's arrow solve on one device: the same robust weights and
    # elimination, without the sharded solve's ~25 s compile
    mesh = make_mesh(2, axis_name="graph")
    ref = dict(pcg=j_sharded(mesh, graphs["pcg"], JParams(**PCG)),
               schur=j_schur(mesh, graphs["schur"], JParams(**DENSE)),
               robust=j_schur(None, graphs["robust"], JParams(**ROBUST)))
    port = {n: f.result() for n, f in port.items()}
    pool.shutdown()
    return dict(graphs=graphs, jobs=jobs, port=port, ref=ref)


def _chi_close(got, want, rel):
    assert abs(float(got) - float(want)) < rel * max(float(want), 1.0)


@pytest.mark.parametrize("n", [2, 4])
def test_edge_sharded_pcg_matches_reference(case, n):
    ranks = case["port"][n]
    assert M.rank_results_equal([r["pcg"] for r in ranks])
    got = ranks[0]["pcg"]
    jg, jchi = case["ref"]["pcg"]
    np.testing.assert_allclose(got["poses"][:N], np.asarray(jg.poses[:N]),
                               atol=2e-3)
    _chi_close(got["chi2"], jchi, 1e-2)
    # and the port's single-device PCG on the same graph
    one, chi = optimize_pose_graph(_graph_torch(case["jobs"][0][1], "cpu"),
                                   GraphSolveParams(**PCG))
    np.testing.assert_allclose(got["poses"], one.poses.numpy(), atol=1e-5)
    _chi_close(got["chi2"], chi, 1e-4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["schur", "robust"])
def test_schur_matches_reference(case, n, name):
    ranks = case["port"][n]
    assert M.rank_results_equal([r[name] for r in ranks])
    got = ranks[0][name]
    jg, jchi = case["ref"][name]
    np.testing.assert_allclose(got["poses"][:N], np.asarray(jg.poses[:N]),
                               atol=1e-4)
    _chi_close(got["chi2"], jchi, 1e-4)
    if name == "robust":
        # and the port's single-device robust dense solve
        one, chi = optimize_pose_graph(
            _graph_torch(case["jobs"][2][1], "cpu"),
            GraphSolveParams(**ROBUST))
        np.testing.assert_allclose(got["poses"][:N], one.poses.numpy()[:N],
                                   atol=1e-4)
        _chi_close(got["chi2"], chi, 1e-4)
    # collectives a Schur GN iteration: one reduce-scatter, the separator
    # system's all-reduce, one all-gather (the module's two Schur solves)
    calls = ranks[0]["calls"]
    assert calls["reduce_scatter"] == calls["all_gather"] == (
        DENSE["gn_iterations"] + ROBUST["gn_iterations"])


def test_schur_single_process_matches_reference_and_dense(case):
    g = _graph_torch(case["jobs"][1][1], "cpu")
    got, chi = optimize_pose_graph_schur(None, g, GraphSolveParams(**DENSE))
    jg, jchi = j_schur(None, case["graphs"]["schur"], JParams(**DENSE))
    np.testing.assert_allclose(got.poses.numpy()[:N],
                               np.asarray(jg.poses[:N]), atol=1e-4)
    _chi_close(chi, jchi, 1e-4)
    dense, dchi = optimize_pose_graph(g, GraphSolveParams(**DENSE))
    np.testing.assert_allclose(got.poses.numpy()[:N], dense.poses.numpy()[:N],
                               atol=1e-4)
    _chi_close(chi, dchi, 1e-4)


@pytest.mark.parametrize("range_size", [4, 8, 16, 32])
def test_separator_mask_matches_reference(case, range_size):
    g = case["graphs"]["robust"]
    args = (32, range_size, np.asarray(g.edge_i), np.asarray(g.edge_j),
            np.asarray(g.edge_mask))
    np.testing.assert_array_equal(separator_mask(*args),
                                  np.asarray(j_separator_mask(*args)))


def test_anneal_deltas_match_reference():
    from tpu_slam.distributed.schur import _anneal_deltas as j_anneal

    for kw in (dict(gn_iterations=8, robust_delta=0.3, robust_anneal=8.0),
               dict(gn_iterations=5, robust_delta=0.0),
               dict(gn_iterations=1, robust_delta=0.2, robust_anneal=4.0)):
        np.testing.assert_array_equal(
            np.asarray(_anneal_deltas(GraphSolveParams(**kw)), np.float32),
            np.asarray(j_anneal(JParams(**kw))))


def test_sharded_solvers_reject_indivisible_capacities():
    mesh = M.Mesh(None, 0, 3, "graph", "gloo", torch.device("cpu"))
    g = _graph_torch(_numpy(_make_noisy_circle_graph(
        np.random.default_rng(0), node_cap=32, edge_cap=64)[0]), "cpu")
    from tpu_slam_torch.distributed.pose_graph_dist import \
        optimize_pose_graph_sharded

    with pytest.raises(ValueError, match="edge capacity"):
        optimize_pose_graph_sharded(mesh, g)
    with pytest.raises(ValueError, match="node capacity"):
        optimize_pose_graph_schur(mesh, g)
