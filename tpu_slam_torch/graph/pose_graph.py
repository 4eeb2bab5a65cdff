"""Pose-graph optimization: Gauss-Newton over SE(3) with a matrix-free PCG.

Port of ``tpu_slam.graph.pose_graph``. The graph is flat tensors padded to
static capacities with a validity mask:

  * edge residuals r_e = log(Z_e^-1 T_i^-1 T_j) and their Jacobians (SE(3)
    adjoints + the second-order inverse left Jacobian) are built for all
    edges at once, as one batch;
  * H @ v is two gathers, batched 6x6 products and two scatter-adds; every
    scatter-add is ``core.scatter.accumulate_rows`` (sort-based, no float
    atomics, the same result run to run), which sums repeated indices
    where ``x[idx] += v`` would keep one write per index;
  * block-Jacobi preconditioned CG solves each GN step (a dense solve is
    kept for small graphs and tests); the gauge is fixed by a prior on
    pose 0.

PCG runs as masked iterations: an iteration updates the solve only while
the reference's ``while_loop`` condition dot(r, r) > cg_tolerance holds,
and the host reads that flag once every ``CG_CHECK_EVERY`` iterations to
stop early. The result is the reference loop's, with one host sync per
CG_CHECK_EVERY iterations instead of one per iteration.

On a CUDA device ``optimize_pose_graph`` (``compiled``, the default, as
the reference jits it) runs the PCG solve as CUDA graphs, captured once
for each (node capacity, edge capacity, params): a GN iteration replays
its fixed work (the rhs and the preconditioner, the CG start) and then
one chunk of CG_CHECK_EVERY masked CG iterations until the flag read
after a chunk says the solve has stopped, then the retract; the live
nodes come from a device count. The dense solver is one CUDA graph, as
the reference's one jit: every GN iteration (H built in a fixed order,
``solve_ex``, the retract of the live nodes) and the final chi^2, keyed
on the graph's tensors' signature and the params (``utils/capture.py``
``compiled_call``), the live node count a () device tensor, so one
capture serves every node count at the same capacities; on the CPU that
body runs eagerly. The work and its order are the eager solve's, so the
bits are too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import compiled_call

CG_CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Flat pose graph (static capacities).

    Attributes:
      poses: (N, 4, 4) world<-node transforms; slots >= n_nodes are identity.
      n_nodes: number of live nodes (a host int; a () device tensor inside
        the dense solver's captured program).
      edge_i, edge_j: (E,) int64 endpoint indices (i < j for odometry edges).
      edge_T: (E, 4, 4) measured relative transform Z = T_i^-1 T_j.
      edge_info: (E, 6, 6) information matrices (Lambda).
      edge_mask: (E,) bool — live edges, packed in a prefix.
    """

    poses: torch.Tensor
    n_nodes: int
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_T: torch.Tensor
    edge_info: torch.Tensor
    edge_mask: torch.Tensor

    @property
    def node_capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def empty_graph(node_capacity: int, edge_capacity: int,
                device=None) -> PoseGraph:
    def eye(n, k):
        return torch.eye(n, dtype=torch.float32,
                         device=device).expand(k, n, n).clone()

    return PoseGraph(
        poses=eye(4, node_capacity), n_nodes=0,
        edge_i=torch.zeros(edge_capacity, dtype=torch.long, device=device),
        edge_j=torch.zeros(edge_capacity, dtype=torch.long, device=device),
        edge_T=eye(4, edge_capacity), edge_info=eye(6, edge_capacity),
        edge_mask=torch.zeros(edge_capacity, dtype=torch.bool,
                              device=device))


@dataclasses.dataclass(frozen=True)
class GraphSolveParams:
    """Static solver configuration (the reference's fields and defaults)."""

    gn_iterations: int = 10
    cg_iterations: int = 50
    cg_tolerance: float = 1e-8
    damping: float = 1e-6          # Levenberg diagonal damping
    prior_weight: float = 1e6      # gauge prior on pose 0
    solver: str = "pcg"            # 'pcg' | 'dense'
    robust_delta: float = 0.0      # robust IRLS width on edge chi (0 = off)
    robust_kernel: str = "cauchy"  # 'huber' | 'cauchy' (redescending)
    robust_anneal: float = 1.0     # first-iteration delta multiplier,
                                   # decayed geometrically to robust_delta
    trust_loops: bool = False      # exempt loop edges (j - i > 1) from the
                                   # robust weight (loops verified upstream
                                   # by the symmetric cycle gate)


# ---------------------------------------------------------------------------
# Residuals and Jacobians (batched over edges)
# ---------------------------------------------------------------------------

def _edge_residual_jac(Ti, Tj, Z):
    """Residual r = log(Z^-1 Ti^-1 Tj) and the Jacobian wrt a left
    perturbation of Tj: with B = (Ti Z)^-1, J_j = Jl^-1(r) Ad(B) and
    J_i = -J_j."""
    E = se3.inverse(Z) @ se3.inverse(Ti) @ Tj
    r = se3.log(E)
    B = se3.inverse(Ti @ Z)
    Jj = se3.left_jacobian_inv_approx(r) @ se3.adjoint(B)
    return r, Jj


def _gather_edge_terms(graph: PoseGraph):
    """Per-edge (r, J_j, weighted information). Masked edges give zeros."""
    r, Jj = _edge_residual_jac(graph.poses[graph.edge_i],
                               graph.poses[graph.edge_j], graph.edge_T)
    w = graph.edge_mask.to(r.dtype)
    return r, Jj, graph.edge_info * w[:, None, None]


def _build_rhs_and_diag(graph: PoseGraph, params: GraphSolveParams,
                        delta: Optional[float] = None):
    """-J^T W r (the GN rhs) and the block diagonal of H (preconditioner).

    ``delta`` is the robust width for this iteration (annealed across GN
    iterations when ``robust_anneal`` > 1).
    """
    n = graph.node_capacity
    r, Jj, info = _gather_edge_terms(graph)
    if params.robust_delta > 0.0:
        d = params.robust_delta if delta is None else delta
        chi = torch.sqrt(torch.clamp(
            torch.einsum("ea,eab,eb->e", r, info, r), min=1e-12))
        if params.robust_kernel == "huber":
            w = torch.where(chi <= d, 1.0, d / chi)
        else:  # cauchy (redescending)
            w = 1.0 / (1.0 + (chi / d) ** 2)
        if params.trust_loops:
            w = torch.where(graph.edge_j - graph.edge_i > 1, 1.0, w)
        info = info * w[:, None, None]
    WJ = info @ Jj                                    # (E, 6, 6)
    Wr = torch.einsum("eab,eb->ea", info, r)
    JtWr_j = torch.einsum("eba,eb->ea", Jj, Wr)       # J_j^T W r
    # rhs = -J^T W r with J_i = -J_j
    b = r.new_zeros((n, 6))
    accumulate_rows(b, graph.edge_i, JtWr_j)
    accumulate_rows(b, graph.edge_j, -JtWr_j)

    JtWJ = torch.einsum("eba,ebc->eac", Jj, WJ)       # J_j^T W J_j
    diag = r.new_zeros((n, 6, 6))
    accumulate_rows(diag, graph.edge_i, JtWJ)
    accumulate_rows(diag, graph.edge_j, JtWJ)
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
    diag[0] += params.prior_weight * eye6             # gauge prior
    diag = diag + params.damping * eye6
    return b, diag, (r, Jj, info)


def _hv(graph: PoseGraph, params: GraphSolveParams, edge_terms,
        v: torch.Tensor) -> torch.Tensor:
    """H @ v without materializing H. v: (N, 6)."""
    _, Jj, info = edge_terms
    # u_e = J_i v_i + J_j v_j = J_j (v_j - v_i)
    u = torch.einsum("eab,eb->ea", Jj, v[graph.edge_j] - v[graph.edge_i])
    Wu = torch.einsum("eab,eb->ea", info, u)
    JtWu = torch.einsum("eba,eb->ea", Jj, Wu)
    out = torch.zeros_like(v)
    accumulate_rows(out, graph.edge_i, -JtWu)
    accumulate_rows(out, graph.edge_j, JtWu)
    out[0] += params.prior_weight * v[0]
    return out + params.damping * v


def _dot(a, c):
    return torch.sum(a * c)


def _cg_active(r, params: GraphSolveParams) -> torch.Tensor:
    """The reference loop's condition: dot(r, r) > cg_tolerance."""
    return _dot(r, r) > params.cg_tolerance


def _pcg_start(graph, params, b, diag, edge_terms):
    """The block-Jacobi preconditioner and the CG start at x = 0:
    (Minv, x, r, p, rz)."""
    # inv_ex: no error check, so no host sync (the damped diagonal blocks
    # are positive definite)
    Minv = torch.linalg.inv_ex(diag)[0]                # (N, 6, 6)
    x = torch.zeros_like(b)
    r = b - _hv(graph, params, edge_terms, x)
    z = torch.einsum("nab,nb->na", Minv, r)
    return Minv, x, r, z, _dot(r, z)


def _pcg_iterations(graph, params, edge_terms, Minv, x, r, p, rz, n: int):
    """``n`` masked CG iterations: each updates (x, r, p, rz) only while
    the loop's condition holds. Those that did are summed on the device
    into the counter ``cg_iters_used`` (``utils.tracing``)."""
    held = []
    for _ in range(n):
        active = _cg_active(r, params)
        held.append(active)
        Hp = _hv(graph, params, edge_terms, p)
        alpha = rz / torch.clamp(_dot(p, Hp), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Hp
        z = torch.einsum("nab,nb->na", Minv, r_new)
        rz_new = _dot(r_new, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    tracing.device_count("cg_iters_used", torch.stack(held).sum())
    return x, r, p, rz


def _chunks(params: GraphSolveParams):
    """The CG iterations in chunks of CG_CHECK_EVERY (the last one
    shorter); the host reads the flag before each."""
    n = params.cg_iterations
    return [min(CG_CHECK_EVERY, n - s) for s in range(0, n, CG_CHECK_EVERY)]


def _solve_pcg(graph, params, b, diag, edge_terms):
    """Block-Jacobi preconditioned CG for H x = b (masked iterations)."""
    Minv, x, r, p, rz = _pcg_start(graph, params, b, diag, edge_terms)
    for n in _chunks(params):
        if not bool(_cg_active(r, params)):
            break
        x, r, p, rz = _pcg_iterations(graph, params, edge_terms, Minv, x, r,
                                      p, rz, n)
        tracing.count("cg_iters_run", n)
    return x


def _solve_dense(graph, params, b, diag, edge_terms):
    """Exact dense solve (small graphs and tests)."""
    n = graph.node_capacity
    _, Jj, info = edge_terms
    JtWJ = torch.einsum("eba,ebc->eac", Jj, info @ Jj)        # (E, 6, 6)
    # the blocks H[ei, :, ej, :] as flat indices into the (6n, 6n) matrix
    a = torch.arange(6, device=b.device)

    def flat(ri, ci):
        rows = ri[:, None, None] * 6 + a[None, :, None]
        cols = ci[:, None, None] * 6 + a[None, None, :]
        return (rows * (6 * n) + cols).reshape(-1)

    ei, ej = graph.edge_i, graph.edge_j
    H = b.new_zeros(36 * n * n)
    for ri, ci, sign in ((ei, ei, 1.0), (ej, ej, 1.0), (ei, ej, -1.0),
                         (ej, ei, -1.0)):
        accumulate_rows(H, flat(ri, ci), sign * JtWJ.reshape(-1))
    Hd = H.reshape(6 * n, 6 * n)
    Hd = Hd + params.damping * torch.eye(6 * n, dtype=b.dtype,
                                         device=b.device)
    Hd[a, a] += params.prior_weight
    x = torch.linalg.solve_ex(Hd, b.reshape(-1))[0]
    return x.reshape(n, 6)


def graph_error(graph: PoseGraph) -> torch.Tensor:
    """Total weighted squared residual over live edges (chi^2)."""
    r, _, info = _gather_edge_terms(graph)
    return torch.sum(torch.einsum("ea,eab,eb->e", r, info, r))


def _robust_deltas(params: GraphSolveParams):
    """Per-GN-iteration robust widths, rounded to float32 as the
    reference's array of them is."""
    K = params.gn_iterations
    if params.robust_delta > 0.0 and K > 1:
        ratio = params.robust_anneal ** (1.0 / (K - 1))
        ds = [params.robust_delta * params.robust_anneal / ratio ** i
              for i in range(K)]
    else:
        ds = [params.robust_delta] * K
    return [float(np.float32(d)) for d in ds]


def _live(graph: PoseGraph, n_nodes) -> torch.Tensor:
    """(N, 1): the slots below ``n_nodes`` (a host int or a device
    count)."""
    return (torch.arange(graph.node_capacity, device=graph.poses.device)
            < n_nodes)[:, None]


def _gn(graph: PoseGraph, params: GraphSolveParams, solve,
        live: torch.Tensor) -> PoseGraph:
    """The GN iterations: each builds the rhs at its robust width, solves
    and retracts the ``live`` nodes."""
    for delta in _robust_deltas(params):
        b, diag, edge_terms = _build_rhs_and_diag(graph, params, delta)
        xi = solve(graph, params, b, diag, edge_terms)
        xi = torch.where(live, xi, 0.0)       # freeze padding nodes
        graph = dataclasses.replace(graph,
                                    poses=se3.retract(graph.poses, xi))
    return graph


def _dense_program(graph: PoseGraph, params: GraphSolveParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense solver's whole solve, sync-free: ``graph.n_nodes`` is a
    () device tensor. Returns the poses and chi^2 (a device scalar)."""
    graph = _gn(graph, params, _solve_dense, _live(graph, graph.n_nodes))
    return graph.poses, graph_error(graph)


_dense_solves: Dict = {}


def optimize_pose_graph(graph: PoseGraph,
                        params: GraphSolveParams = GraphSolveParams(),
                        compiled: bool = True
                        ) -> Tuple[PoseGraph, torch.Tensor]:
    """Run GN iterations; returns (optimized graph, final chi^2).

    With a robust kernel active, its width is annealed from
    robust_anneal x the target down to the target over the iterations.
    ``compiled`` (module docstring): the PCG solver's captured solve on a
    CUDA device, eager elsewhere; the dense solver's one graph a (graph
    signature, params) on a CUDA device, its sync-free body run eagerly
    elsewhere. ``compiled=False`` runs the eager loop, which reads the
    PCG's stop flag and takes the node count as a host int.
    """
    dev = graph.poses.device
    if compiled and params.solver == "dense":
        n = torch.full((), graph.n_nodes, dtype=torch.long, device=dev)
        poses, chi2 = compiled_call(
            _dense_solves, functools.partial(_dense_program, params=params),
            (dataclasses.replace(graph, n_nodes=n),), static=params)
        return dataclasses.replace(graph, poses=poses), chi2
    if compiled and dev.type == "cuda":
        return captured_solve(graph, params).run(graph)
    solve = _solve_dense if params.solver == "dense" else _solve_pcg
    graph = _gn(graph, params, solve, _live(graph, graph.n_nodes))
    return graph, graph_error(graph)


_GRAPH_TENSORS = ("poses", "edge_i", "edge_j", "edge_T", "edge_info",
                  "edge_mask")


class CapturedSolve:
    """``optimize_pose_graph``'s PCG solve as CUDA graphs for one (node
    capacity, edge capacity, params) on one device.

    Static buffers hold the graph (poses, edges, the live node count) and
    what crosses between the graphs (the edge Jacobians and weights, the
    preconditioner, the CG iterate and its flag). ``fixed[delta]`` builds
    a GN iteration's rhs and preconditioner and starts the CG (one graph
    for each robust width), ``chunk[n]`` runs n masked CG iterations in
    place, ``retract`` applies the step to the live nodes.
    """

    def __init__(self, graph: PoseGraph, params: GraphSolveParams):
        from tpu_slam_torch.utils.capture import Captured

        dev = graph.poses.device
        self.params = params
        self.graph = dataclasses.replace(
            graph, **{f: getattr(graph, f).clone() for f in _GRAPH_TENSORS})
        self.n_nodes = torch.zeros((), dtype=torch.long, device=dev)
        # the buffers between the graphs, made at the first warm-up with
        # the strides the eager solve's tensors have (a product's kernel,
        # and so its bits, may follow the strides)
        self.bufs: Dict[str, torch.Tensor] = {}
        self.fixed = {d: Captured(lambda d=d: self._fixed(d), dev)
                      for d in sorted(set(_robust_deltas(params)))}
        self.chunk = {k: Captured(lambda k=k: self._chunk(k), dev)
                      for k in sorted(set(_chunks(params)))}
        self.retract = Captured(self._retract, dev)

    def _keep(self, **values):
        """Copy each value into its buffer (made at the first call)."""
        for name, v in values.items():
            if name not in self.bufs:
                self.bufs[name] = torch.empty_like(v)
            self.bufs[name].copy_(v)

    def _set_cg(self, x, r, p, rz):
        self._keep(x=x, r=r, p=p, rz=rz, active=_cg_active(r, self.params))

    def _fixed(self, delta: float):
        b, diag, (_, Jj, info) = _build_rhs_and_diag(self.graph, self.params,
                                                     delta)
        self._keep(Jj=Jj, info=info)
        terms = (None, self.bufs["Jj"], self.bufs["info"])
        Minv, x, r, p, rz = _pcg_start(self.graph, self.params, b, diag,
                                       terms)
        self._keep(Minv=Minv)
        self._set_cg(x, r, p, rz)

    def _chunk(self, k: int):
        s = self.bufs
        self._set_cg(*_pcg_iterations(
            self.graph, self.params, (None, s["Jj"], s["info"]), s["Minv"],
            s["x"], s["r"], s["p"], s["rz"], k))

    def _retract(self):
        g = self.graph
        live = (torch.arange(g.node_capacity, device=g.poses.device)
                < self.n_nodes)[:, None]
        xi = torch.where(live, self.bufs["x"], 0.0)
        g.poses.copy_(se3.retract(g.poses, xi))

    def run(self, graph: PoseGraph) -> Tuple[PoseGraph, torch.Tensor]:
        g = self.graph
        for f in _GRAPH_TENSORS:
            getattr(g, f).copy_(getattr(graph, f))
        self.n_nodes.fill_(graph.n_nodes)
        for delta in _robust_deltas(self.params):
            self.fixed[delta].replay()
            for k in _chunks(self.params):
                with tracing.span("cg.flag_read"):
                    live = bool(self.bufs["active"])
                if not live:
                    break
                self.chunk[k].replay()
                tracing.count("cg_iters_run", k)
            self.retract.replay()
        out = dataclasses.replace(graph, poses=g.poses.clone())
        return out, graph_error(out)


_solves: Dict[Tuple, CapturedSolve] = {}


def captured_solve(graph: PoseGraph, params: GraphSolveParams
                   ) -> CapturedSolve:
    """The cached captured solve for ``graph``'s capacities, device and
    ``params``, captured at its first request."""
    # the strides too: a product's kernel, and so its bits, may follow them
    key = (graph.node_capacity, graph.edge_capacity, params,
           graph.poses.device, graph.poses.dtype,
           tuple(getattr(graph, f).stride() for f in _GRAPH_TENSORS))
    solve = _solves.get(key)
    if solve is None:
        solve = CapturedSolve(graph, params)
        _solves[key] = solve
    return solve


# ---------------------------------------------------------------------------
# Host-side graph construction helpers
# ---------------------------------------------------------------------------

def add_node(graph: PoseGraph, pose: torch.Tensor) -> Tuple[PoseGraph, int]:
    """Append a node; returns (graph, its index)."""
    idx = graph.n_nodes
    if idx >= graph.node_capacity:
        raise ValueError(f"node capacity {graph.node_capacity} exhausted")
    poses = graph.poses.clone()
    poses[idx] = pose
    return dataclasses.replace(graph, poses=poses, n_nodes=idx + 1), idx


def n_edges(graph: PoseGraph) -> int:
    """Number of live edges (edges are always packed in a prefix)."""
    return int(graph.edge_mask.sum())


def drop_node_prefix(graph: PoseGraph, m: int) -> PoseGraph:
    """Drop the first ``m`` nodes — sliding-window eviction (host-side).

    Surviving nodes shift down by m; edges touching a dropped node are
    removed and the rest repacked into a prefix. Dropped edges are not
    marginalized: the gauge prior on the new node 0 anchors the window at
    its current optimized pose.
    """
    n = graph.n_nodes
    if not 0 < m < n:
        raise ValueError(f"need 0 < m < n_nodes, got m={m}, n={n}")
    ei = graph.edge_i.cpu().numpy()
    ej = graph.edge_j.cpu().numpy()
    keep = graph.edge_mask.cpu().numpy() & (ei >= m) & (ej >= m)
    order = np.argsort(~keep, kind="stable")          # kept edges first
    shift = np.where(keep[order], m, 0)
    dev = graph.poses.device
    order_t = torch.as_tensor(order, device=dev)
    eye = torch.eye(4, dtype=graph.poses.dtype, device=dev).expand(m, 4, 4)
    return dataclasses.replace(
        graph,
        poses=torch.cat([graph.poses[m:], eye]),
        n_nodes=n - m,
        edge_i=torch.as_tensor(ei[order] - shift, dtype=torch.long,
                               device=dev),
        edge_j=torch.as_tensor(ej[order] - shift, dtype=torch.long,
                               device=dev),
        edge_T=graph.edge_T[order_t],
        edge_info=graph.edge_info[order_t],
        edge_mask=torch.as_tensor(keep[order], device=dev))


def add_edge(graph: PoseGraph, i: int, j: int, Z: torch.Tensor,
             info: Optional[torch.Tensor] = None) -> PoseGraph:
    """Append an edge with measurement Z = T_i^-1 T_j (host-side)."""
    e = n_edges(graph)
    if e >= graph.edge_capacity:
        raise ValueError(f"edge capacity {graph.edge_capacity} exhausted")
    out = dataclasses.replace(
        graph, edge_i=graph.edge_i.clone(), edge_j=graph.edge_j.clone(),
        edge_T=graph.edge_T.clone(), edge_info=graph.edge_info.clone(),
        edge_mask=graph.edge_mask.clone())
    out.edge_i[e] = i
    out.edge_j[e] = j
    out.edge_T[e] = Z
    if info is None:
        out.edge_info[e] = torch.eye(6, dtype=graph.edge_info.dtype,
                                     device=graph.edge_info.device)
    else:
        out.edge_info[e] = info
    out.edge_mask[e] = True
    return out
