"""Distributed Schur-complement pose-graph solve (keyframe-range sharding).

Port of ``tpu_slam.distributed.schur``. A long trajectory's pose graph is an
arrow system: a block-tridiagonal odometry chain plus a few long-range
loop couplings. The solve exploits it exactly:

  * poses are split into D contiguous keyframe ranges, one a rank;
  * separators are the poses that couple ranges: range-boundary poses,
    loop-closure endpoints and pose 0 (the gauge prior); every other pose
    is interior, coupled only to its chain neighbours;
  * each rank eliminates its interior poses with a forward
    block-tridiagonal pass (exact 6x6 inverses, emitting Schur terms onto
    the separator system), the separator system is all-reduced and solved
    dense on every rank, and a reverse pass back-substitutes.

Collectives a GN iteration: one reduce-scatter handing each rank its
range's assembled block rows, one all-reduce of the separator system and
its rhs, one all-gather of the (N, 6) update.

The reference's elimination and back-substitution are ``lax.scan``s of
6x6 ops; here they are loops over the rank's N/D poses unrolled on the
host, and since the separator flags are host values (numpy) each step
runs only its own branch: a dozen small ops a pose. The linear solve runs
in float64 (``_schur_gn``). The edge linearisation is
``graph.pose_graph._edge_residual_jac``, so the solve agrees with
``optimize_pose_graph`` to float tolerance.

The whole solve is the reference's compiled program: every GN iteration,
the elimination, the separator solve, back-substitution and the retract
are one CUDA graph for each separator structure, node count, params and
inputs' signature, χ² left on the card (``compiled=None``, the default:
captured with no mesh or on NCCL, whose collectives are captured with the
rest; eager on gloo, whose collectives go through host memory;
``compiled=True`` on gloo raises, ``mesh.captured_form``). The structure
is read from the edges on the host before it (the key), and the index
tensors it implies are made there too (``_index_tensors``): a copy from
host memory cannot run inside a capture.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.distributed import mesh as mesh_mod
from tpu_slam_torch.distributed.pose_graph_dist import edge_shard
from tpu_slam_torch.graph.pose_graph import (GraphSolveParams, PoseGraph,
                                             _edge_residual_jac)
from tpu_slam_torch.utils.capture import compiled_call

# the captured solves, one for each (inputs' signature, mesh, structure,
# node count, params)
_solves: Dict = {}


def separator_mask(n_cap: int, range_size: int, edge_i: np.ndarray,
                   edge_j: np.ndarray, edge_mask: np.ndarray) -> np.ndarray:
    """Host-side separator classification: pose 0, the range-boundary
    poses (k mod K in {0, K-1}), and the endpoints of non-consecutive
    (loop) edges."""
    sep = np.zeros((n_cap,), bool)
    sep[0] = True
    k = np.arange(n_cap)
    sep |= (k % range_size == 0) | (k % range_size == range_size - 1)
    loop = edge_mask & (edge_j != edge_i + 1)
    sep[edge_i[loop]] = True
    sep[edge_j[loop]] = True
    return sep


def _robust_weights(r, info, params: GraphSolveParams, delta: float):
    """IRLS reweighting on edge chi (the kernels of graph.pose_graph)."""
    if params.robust_delta <= 0.0:
        return info
    chi = torch.sqrt(torch.clamp(torch.einsum("ea,eab,eb->e", r, info, r),
                                 min=1e-12))
    if params.robust_kernel == "huber":
        w = torch.where(chi <= delta, 1.0, delta / chi)
    else:
        w = 1.0 / (1.0 + (chi / delta) ** 2)
    return info * w[:, None, None]


def _anneal_deltas(params: GraphSolveParams) -> List[float]:
    """Per-GN-iteration robust widths (float32, as the reference's array)."""
    K = params.gn_iterations
    if params.robust_delta > 0.0 and K > 1 and params.robust_anneal != 1.0:
        ratio = params.robust_anneal ** (1.0 / (K - 1))
        ds = [params.robust_delta * params.robust_anneal / ratio ** i
              for i in range(K)]
    else:
        ds = [params.robust_delta] * K
    return [float(np.float32(d)) for d in ds]


@dataclasses.dataclass
class _Elimination:
    """What the forward pass emits onto the separator system, and the
    factors back-substitution needs (one entry per interior pose)."""

    diag_blk: List[torch.Tensor]      # at _elimination_slots' diag
    rhs: List[torch.Tensor]
    cpl_blk: List[torch.Tensor]       # block at S[prev, slot], each cpl
    Ainv: dict
    b_eff: dict
    G: dict
    prev: dict


def _elimination_slots(is_sep: np.ndarray, slot: np.ndarray,
                       sentinel: int) -> Tuple[List[int], List[Tuple]]:
    """Where ``_eliminate`` writes on the separator system, from the
    structure alone: each pose's diagonal slot (its own for a separator,
    the previous separator's for an interior pose; ``sentinel`` before
    the first), and each separator's coupling (previous separator, its
    slot)."""
    diag, cpl, prev = [], [], sentinel
    for k in range(len(is_sep)):
        if is_sep[k]:
            s = int(slot[k])
            diag.append(s)
            if prev != sentinel:
                cpl.append((prev, s))
            prev = s
        else:
            diag.append(prev)
    return diag, cpl


def _eliminate(A, b, B, is_sep: np.ndarray, slot: np.ndarray,
               sentinel: int) -> _Elimination:
    """Forward block-tridiagonal elimination over one keyframe range.

    A (K, 6, 6) diagonal blocks (damping and prior included), b (K, 6),
    B (K, 6, 6) chain coupling H[k, k+1] (zero at the range's last pose and
    where no in-range chain edge exists). Interior pose k is eliminated
    exactly:

        S[sp, sp] -= G_k^T Ainv G_k        (sp = previous separator)
        rhs[sp]   -= G_k^T Ainv b_k
        M_{k+1}    = -B_k^T Ainv B_k
        G_{k+1}    = -B_k^T Ainv G_k

    while separator pose k deposits its conditioned diagonal A_k + M_k, its
    rhs and the accumulated coupling G_k onto the separator system and
    resets the chain (G_{k+1} = B_k^T).
    """
    K = A.shape[0]
    zero6 = torch.zeros((6, 6), dtype=A.dtype, device=A.device)
    M, m, G, prev = zero6, torch.zeros_like(b[0]), zero6, sentinel
    out = _Elimination([], [], [], {}, {}, {}, {})
    for k in range(K):
        A_eff = A[k] + M
        b_eff = b[k] + m
        B_k = B[k]
        if is_sep[k]:
            s = int(slot[k])
            out.diag_blk.append(A_eff)
            out.rhs.append(b_eff)
            if prev != sentinel:
                out.cpl_blk.append(G.T)
            M, m, G, prev = zero6, torch.zeros_like(m), B_k.T, s
        else:
            Ainv = torch.linalg.inv_ex(A_eff)[0]
            GtAinv = G.T @ Ainv
            BtAinv = B_k.T @ Ainv
            out.diag_blk.append(-GtAinv @ G)
            out.rhs.append(-GtAinv @ b_eff)
            out.Ainv[k], out.b_eff[k], out.G[k], out.prev[k] = (
                Ainv, b_eff, G, prev)
            M, m, G = -BtAinv @ B_k, -BtAinv @ b_eff, -BtAinv @ G
    return out


def _backsubstitute(el: _Elimination, B, is_sep: np.ndarray,
                    slot: np.ndarray, x_sep) -> torch.Tensor:
    """Reverse pass: x_k = Ainv (b_eff - B_k x_{k+1} - G_k x_sp) for an
    interior pose, the separator solution for a separator."""
    K = B.shape[0]
    xs = [None] * K
    x_next = torch.zeros_like(x_sep[0])
    for k in range(K - 1, -1, -1):
        if is_sep[k]:
            x_k = x_sep[int(slot[k])]
        else:
            x_k = el.Ainv[k] @ (el.b_eff[k] - B[k] @ x_next
                                - el.G[k] @ x_sep[el.prev[k]])
        xs[k] = x_k
        x_next = x_k
    return torch.stack(xs)


def _index_tensors(sep_l: np.ndarray, slot_l: np.ndarray,
                   slots: np.ndarray, slot_node: np.ndarray, n_nodes: int,
                   nsep_cap: int, device):
    """The device tensors a solve's structure implies: each pose's
    separator slot, the live slots (of nodes below ``n_nodes``) and the
    separator system's unit diagonal of the others, and the flat
    separator-system rows of the forward pass's blocks (diagonals, then
    each coupling and its transpose) and of its rhs."""
    n_sys = nsep_cap + 1
    diag, cpl = _elimination_slots(sep_l, slot_l, nsep_cap)
    blk_rows = [a * n_sys + a for a in diag]
    for p, q in cpl:
        blk_rows += [p * n_sys + q, q * n_sys + p]
    live_slot = slot_node < n_nodes
    return (torch.as_tensor(slots, dtype=torch.long, device=device),
            torch.as_tensor(live_slot, device=device),
            torch.as_tensor(np.repeat(~live_slot, 6), dtype=torch.float64,
                            device=device),
            torch.as_tensor(blk_rows, dtype=torch.long, device=device),
            torch.as_tensor(diag, dtype=torch.long, device=device))


def _schur_gn(mesh: Optional[mesh_mod.Mesh], poses: torch.Tensor, edges,
              index, sep: np.ndarray, slots: np.ndarray,
              params: GraphSolveParams, nsep_cap: int, range_size: int,
              n_nodes: int):
    """One full GN solve on this rank's edge shard (the whole graph's
    edges when ``mesh`` is None); poses replicated. ``index``:
    ``_index_tensors``. Reads nothing back (the captured solve's body).

    The linear solve (block rows, elimination, separator system,
    back-substitution) runs in float64 whatever the poses' type: the
    recurrence chains N/D dependent 6x6 inverses, and in float32 it left
    config 4's 216-pose graph 1.6 mm from the exact GN solution, farther
    than a dense float32 solve (the reference runs its matmuls at HIGHEST
    for the same reason). The blocks are tiny.
    """
    ei, ej, eT, einfo, emask = edges
    slots_t, live_slot, pad_diag, blk_rows, rhs_rows = index
    dev, dtype = poses.device, poses.dtype
    n_cap = poses.shape[0]
    K = range_size
    rank = 0 if mesh is None else mesh.rank
    off = rank * K
    sentinel = nsep_cap
    wdt = torch.float64
    eye6 = torch.eye(6, dtype=wdt, device=dev)
    sep_l = sep[off:off + K]
    slot_l = slots[off:off + K]
    n_sys = nsep_cap + 1

    def psum(x):
        return x if mesh is None else mesh_mod.all_reduce(mesh, x)

    chain = emask & (ej == ei + 1) & (ei % K != K - 1)
    direct = emask & ~chain
    si = torch.where(direct, slots_t[ei], sentinel)
    sj = torch.where(direct, slots_t[ej], sentinel)
    live = (torch.arange(n_cap, device=dev) < n_nodes)[:, None]

    for delta in _anneal_deltas(params):
        r, Jj = _edge_residual_jac(poses[ei], poses[ej], eT)
        w = emask.to(dtype)
        info = _robust_weights(r, einfo * w[:, None, None], params, delta)
        JtWJ = torch.einsum("eba,ebc->eac", Jj, info @ Jj).to(wdt)
        JtWr = torch.einsum("eba,ebc,ec->ea", Jj, info, r).to(wdt)

        # block rows (diagonal A, rhs b, chain coupling B) over the local
        # edges, then each rank receives its range's rows, summed
        A = JtWJ.new_zeros((n_cap, 6, 6))
        accumulate_rows(A, ei, JtWJ)
        accumulate_rows(A, ej, JtWJ)
        bvec = JtWr.new_zeros((n_cap, 6))
        accumulate_rows(bvec, ei, JtWr)
        accumulate_rows(bvec, ej, -JtWr)
        Bcpl = JtWJ.new_zeros((n_cap, 6, 6))
        accumulate_rows(Bcpl, torch.where(chain, ei, n_cap - 1),
                        torch.where(chain[:, None, None], -JtWJ, 0.0))
        rows = torch.cat([A.reshape(n_cap, 36), bvec,
                          Bcpl.reshape(n_cap, 36)], dim=1)
        if mesh is not None:
            rows = mesh_mod.reduce_scatter(mesh, rows)
        A = rows[:, :36].reshape(K, 6, 6) + params.damping * eye6
        bvec = rows[:, 36:42]
        Bcpl = rows[:, 42:].reshape(K, 6, 6)
        if off == 0:
            A = A.clone()
            A[0] += params.prior_weight * eye6             # gauge prior

        el = _eliminate(A, bvec, Bcpl, sep_l, slot_l, sentinel)

        # the separator system (padded by one sentinel row and column)
        S = JtWJ.new_zeros((n_sys * n_sys, 6, 6))
        blks = list(el.diag_blk)
        for blk in el.cpl_blk:
            blks += [blk, blk.T]
        accumulate_rows(S, blk_rows, torch.stack(blks))
        rhs = JtWr.new_zeros((n_sys, 6))
        accumulate_rows(rhs, rhs_rows, torch.stack(el.rhs))
        # direct separator-separator edges: loops and range-crossing chain
        # edges (off-diagonal blocks; their diagonals went through A)
        neg = torch.where(direct[:, None, None], -JtWJ, 0.0)
        accumulate_rows(S, si * n_sys + sj, neg)
        accumulate_rows(S, sj * n_sys + si, neg)
        both = psum(torch.cat([S.reshape(-1), rhs.reshape(-1)]))
        S = both[:n_sys * n_sys * 36].reshape(n_sys, n_sys, 6, 6)
        rhs = both[n_sys * n_sys * 36:].reshape(n_sys, 6)

        # dense separator solve, replicated. Unused slots and slots of
        # padding nodes (only the damping on their diagonal: hopeless
        # conditioning against the gauge prior in float32) get identity
        # diagonals; their rows and columns are zero, so that decouples them
        Ssys = S[:nsep_cap, :nsep_cap].permute(0, 2, 1, 3).reshape(
            nsep_cap * 6, nsep_cap * 6)
        Ssys = Ssys + torch.diag(pad_diag)
        rhs_sep = torch.where(live_slot[:, None], rhs[:nsep_cap], 0.0)
        x_sep = torch.linalg.solve_ex(Ssys, rhs_sep.reshape(-1))[0].reshape(
            nsep_cap, 6)

        xs = _backsubstitute(el, Bcpl, sep_l, slot_l, x_sep)       # (K, 6)
        xi = xs if mesh is None else mesh_mod.all_gather(mesh, xs)
        xi = torch.where(live, xi.to(dtype), 0.0)
        poses = se3.retract(poses, xi)

    r, _ = _edge_residual_jac(poses[ei], poses[ej], eT)
    info = einfo * emask.to(dtype)[:, None, None]
    chi2 = psum(torch.sum(torch.einsum("ea,eab,eb->e", r, info, r))[None])[0]
    return poses, chi2


def optimize_pose_graph_schur(mesh: Optional[mesh_mod.Mesh],
                              graph: PoseGraph,
                              params: GraphSolveParams = GraphSolveParams(),
                              axis_name: Optional[str] = None,
                              compiled: Optional[bool] = None
                              ) -> Tuple[PoseGraph, torch.Tensor]:
    """GN over the graph with the range-sharded Schur elimination.

    ``mesh=None`` runs the same arrow solve in this process alone (the
    separator structure still applies). Every rank passes the whole graph.
    Node capacity must divide the ranks, and edge capacity too; the
    separator system's capacity is bucketed to multiples of 16.
    ``compiled``: the captured solve or the eager one (module docstring);
    on the CPU the captured form's body runs eagerly.
    """
    if mesh is not None and axis_name is not None \
            and axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}")
    n_dev = 1 if mesh is None else mesh.size
    n_cap = graph.node_capacity
    if n_cap % n_dev:
        raise ValueError(f"node capacity {n_cap} not divisible by {n_dev} "
                         "ranks")
    K = n_cap // n_dev
    edges = ((graph.edge_i, graph.edge_j, graph.edge_T, graph.edge_info,
              graph.edge_mask) if mesh is None else edge_shard(mesh, graph))
    captured = mesh_mod.captured_form(mesh, compiled)
    ei = graph.edge_i.cpu().numpy()
    ej = graph.edge_j.cpu().numpy()
    em = graph.edge_mask.cpu().numpy()
    sep = separator_mask(n_cap, K, ei, ej, em)
    nsep = int(sep.sum())
    nsep_cap = max(16, -(-nsep // 16) * 16)
    slots = np.full((n_cap,), nsep_cap, np.int64)
    slots[sep] = np.arange(nsep)
    slot_node = np.full((nsep_cap,), n_cap, np.int64)
    slot_node[:nsep] = np.nonzero(sep)[0]
    off = (0 if mesh is None else mesh.rank) * K
    index = _index_tensors(sep[off:off + K], slots[off:off + K], slots,
                           slot_node, graph.n_nodes, nsep_cap,
                           graph.poses.device)
    body = functools.partial(_schur_gn, mesh, sep=sep, slots=slots,
                             params=params, nsep_cap=nsep_cap, range_size=K,
                             n_nodes=graph.n_nodes)
    args = (graph.poses, edges, index)
    if captured:
        poses, chi2 = compiled_call(_solves, body, args, static=(
            mesh_mod.program_key(mesh), sep.tobytes(), nsep_cap, K,
            graph.n_nodes, params))
    else:
        poses, chi2 = body(*args)
    return dataclasses.replace(graph, poses=poses), chi2
