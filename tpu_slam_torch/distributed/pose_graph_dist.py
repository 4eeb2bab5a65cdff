"""Distributed pose-graph Gauss-Newton: edge-sharded PCG over the ranks.

Port of ``tpu_slam.distributed.pose_graph_dist``. Long trajectories make
graphs whose dominant cost is the per-edge work (residuals, Jacobians, Hv
products), so:

  * edges are sharded over the ranks, each holding a contiguous block of
    E / D edge slots;
  * poses and CG vectors are replicated ((N, 6) floats) and the partial
    sums are all-reduced.

Every CG iteration is local gathers over the rank's edges, batched 6x6
products, one all-reduce of the (N, 6) partial Hv, and the CG scalars from
replicated vectors. The residuals and Jacobians are
``graph.pose_graph._edge_residual_jac``, so the solve agrees with
``optimize_pose_graph`` to float tolerance. As in the single-device port,
CG iterates masked and the host reads the exit flag once every
``CG_CHECK_EVERY`` iterations; the flag is computed from all-reduced values,
so every rank takes the same branch and ends with the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.distributed import mesh as mesh_mod
from tpu_slam_torch.graph.pose_graph import (CG_CHECK_EVERY,
                                             GraphSolveParams, PoseGraph,
                                             _edge_residual_jac)


def _local_edge_terms(poses, edge_i, edge_j, edge_T, edge_info, edge_mask):
    r, Jj = _edge_residual_jac(poses[edge_i], poses[edge_j], edge_T)
    info = edge_info * edge_mask.to(r.dtype)[:, None, None]
    return r, Jj, info


def edge_shard(mesh: mesh_mod.Mesh, graph: PoseGraph):
    """This rank's contiguous block of edge slots: (i, j, T, info, mask)."""
    E = graph.edge_capacity
    if E % mesh.size:
        raise ValueError(f"edge capacity {E} not divisible by {mesh.size} "
                         "ranks; pad the graph")
    k = E // mesh.size
    s = slice(mesh.rank * k, (mesh.rank + 1) * k)
    return (graph.edge_i[s], graph.edge_j[s], graph.edge_T[s],
            graph.edge_info[s], graph.edge_mask[s])


def optimize_pose_graph_sharded(mesh: mesh_mod.Mesh, graph: PoseGraph,
                                params: GraphSolveParams = GraphSolveParams(),
                                axis_name: Optional[str] = None
                                ) -> Tuple[PoseGraph, torch.Tensor]:
    """GN with edge-sharded PCG (no robust kernel, as the reference).
    Every rank passes the whole graph; edge capacity must divide the ranks
    (masked edges contribute zeros). Returns (graph, chi^2) on every
    rank."""
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}")
    ei, ej, eT, einfo, emask = edge_shard(mesh, graph)
    n = graph.node_capacity
    poses = graph.poses
    dev, dtype = poses.device, poses.dtype
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def build_rhs_diag(p):
        r, Jj, info = _local_edge_terms(p, ei, ej, eT, einfo, emask)
        WJ = info @ Jj
        Wr = torch.einsum("eab,eb->ea", info, r)
        JtWr_j = torch.einsum("eba,eb->ea", Jj, Wr)
        JtWJ = torch.einsum("eba,ebc->eac", Jj, WJ)
        b = r.new_zeros((n, 6))
        accumulate_rows(b, ei, JtWr_j)
        accumulate_rows(b, ej, -JtWr_j)
        diag = r.new_zeros((n, 6, 6))
        accumulate_rows(diag, ei, JtWJ)
        accumulate_rows(diag, ej, JtWJ)
        # one all-reduce for both: [b (6n), diag (36n)]
        both = mesh_mod.all_reduce(
            mesh, torch.cat([b.reshape(-1), diag.reshape(-1)]))
        b = both[:6 * n].reshape(n, 6)
        diag = both[6 * n:].reshape(n, 6, 6).clone()
        diag[0] += params.prior_weight * eye6
        diag = diag + params.damping * eye6
        return b, diag, (Jj, info)

    def hv(terms, v):
        Jj, info = terms
        u = torch.einsum("eab,eb->ea", Jj, v[ej] - v[ei])
        Wu = torch.einsum("eab,eb->ea", info, u)
        JtWu = torch.einsum("eba,eb->ea", Jj, Wu)
        out = torch.zeros_like(v)
        accumulate_rows(out, ei, -JtWu)
        accumulate_rows(out, ej, JtWu)
        out = mesh_mod.all_reduce(mesh, out)
        out[0] += params.prior_weight * v[0]
        return out + params.damping * v

    def pcg(terms, b, diag):
        Minv = torch.linalg.inv_ex(diag)[0]

        def precond(x):
            return torch.einsum("nab,nb->na", Minv, x)

        def dot(a, c):
            return torch.sum(a * c)

        x = torch.zeros_like(b)
        r = b - hv(terms, x)
        z = precond(r)
        p = z
        rz = dot(r, z)
        for it in range(params.cg_iterations):
            active = dot(r, r) > params.cg_tolerance
            if it % CG_CHECK_EVERY == 0 and not bool(active):
                break
            Hp = hv(terms, p)
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

    live = (torch.arange(n, device=dev) < graph.n_nodes)[:, None]
    for _ in range(params.gn_iterations):
        b, diag, terms = build_rhs_diag(poses)
        xi = torch.where(live, pcg(terms, b, diag), 0.0)
        poses = se3.retract(poses, xi)
    r, _, info = _local_edge_terms(poses, ei, ej, eT, einfo, emask)
    chi2 = mesh_mod.all_reduce(
        mesh, torch.sum(torch.einsum("ea,eab,eb->e", r, info, r))[None])[0]
    return dataclasses.replace(graph, poses=poses), chi2
