"""Loop-closure detection: proximity candidates + batched ICP verification.

Port of ``tpu_slam.graph.loop_closure``. Candidates come from a dense
pairwise keyframe-distance matrix on the host (numpy, a copy of the
reference's code); verification registers every candidate pair in one
batched ICP solve per direction (``registration.icp`` with a leading pair
dimension, one NN kernel launch per iteration for all pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph.scan_context import ScanContextParams
from tpu_slam_torch.registration.icp import ICPParams, ICPResult, icp


@dataclasses.dataclass(frozen=True)
class LoopClosureParams:
    """Static loop-closure configuration (the reference's fields)."""

    max_distance: float = 2.0        # candidate gate on position distance
    min_index_gap: int = 20          # skip temporally adjacent keyframes
    max_candidates: int = 16         # per detection sweep
    min_matched_fraction: float = 0.5
    max_error: float = 0.05          # mean squared residual acceptance gate
    max_correction_t: float = 3.0    # consistency gate: reject constraints
    max_correction_r: float = 0.5    # deviating from the current estimate
                                     # by more than this (m / rad)
    icp: ICPParams = ICPParams(max_iterations=30, max_corr_dist=1.0,
                               huber_delta=0.3)
    plane_verify: bool = True        # point-to-plane against stored normals
    symmetric_verify: bool = True    # also register i onto j; gate on the
    max_cycle_t: float = 0.05        # cycle error ||log(Z_fwd Z_rev)|| (m)
    max_cycle_r: float = 0.03        # ... (rad)
    retry_cooldown: int = 6          # sweeps a rejected pair sits out
    use_scan_context: bool = True    # appearance channel
    sc_max_distance: float = 0.22    # min-over-rotation SC distance gate
    sc_top_k: int = 3                # best matches proposed per keyframe
    sc_max_pose_distance: float = 4.0  # appearance matches farther than
                                     # this from the current estimate are
                                     # place-aliases
    sc: ScanContextParams = ScanContextParams()


def propose_candidates(positions, n_nodes: int, params: LoopClosureParams
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Proximity-gated candidate pairs (i, j), i + gap <= j.

    positions: (N, 3) keyframe positions (a tensor or an array). Host-side.
    Returns up to ``max_candidates`` pairs, nearest-first.
    """
    n = int(n_nodes)
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().numpy()
    pos = np.asarray(positions)[:n]
    if n < params.min_index_gap + 2:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ok = (jj - ii >= params.min_index_gap) & (d <= params.max_distance)
    ci, cj = np.nonzero(ok)
    if ci.size == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    order = np.argsort(d[ci, cj], kind="stable")[:params.max_candidates]
    return ci[order].astype(np.int32), cj[order].astype(np.int32)


def verify_candidates(clouds_points: torch.Tensor, clouds_mask: torch.Tensor,
                      poses: torch.Tensor, cand_i: np.ndarray,
                      cand_j: np.ndarray, params: LoopClosureParams,
                      clouds_normals: Optional[torch.Tensor] = None
                      ) -> Tuple[ICPResult, torch.Tensor]:
    """Register candidate pairs in one batch per direction.

    Args:
      clouds_points: (N, P, 3) keyframe clouds in their own body frames.
      clouds_mask: (N, P) validity.
      poses: (N, 4, 4) current world<-keyframe estimates (init guesses).
      cand_i/cand_j: (K,) candidate indices (host arrays).
      clouds_normals: (N, P, 3) per-point normals, required for the
        point-to-plane solve and gate (params.plane_verify).

    Returns (ICPResult with leading axis K, accept (K,) bool). ICP maps
    source = cloud_j onto target = cloud_i, so result.T is the refined
    Z = T_i^-1 T_j of edge (i, j).
    """
    plane = params.plane_verify and clouds_normals is not None
    dev = clouds_points.device
    ci = torch.as_tensor(np.asarray(cand_i), dtype=torch.long, device=dev)
    cj = torch.as_tensor(np.asarray(cand_j), dtype=torch.long, device=dev)
    src = PointCloud(points=clouds_points[cj], mask=clouds_mask[cj])
    tgt = PointCloud(points=clouds_points[ci], mask=clouds_mask[ci])
    init = se3.inverse(poses[ci]) @ poses[cj]

    icp_params = params.icp
    tgt_nrm = src_nrm = None
    if plane:
        icp_params = dataclasses.replace(icp_params, point_to_plane=True)
        tgt_nrm, src_nrm = clouds_normals[ci], clouds_normals[cj]
    res = icp(src, tgt, init_T=init, params=icp_params,
              target_normals=tgt_nrm)
    # gate on solution quality (match fraction + residual) and on
    # consistency with the current estimate, not on the step-norm flag
    dev_xi = se3.log(se3.inverse(res.T) @ init)
    accept = ((res.matched_fraction >= params.min_matched_fraction)
              & (res.error <= params.max_error)
              & (torch.linalg.vector_norm(dev_xi[:, :3], dim=1)
                 <= params.max_correction_t)
              & (torch.linalg.vector_norm(dev_xi[:, 3:], dim=1)
                 <= params.max_correction_r))
    if params.symmetric_verify:
        res_rev = icp(tgt, src, init_T=se3.inverse(res.T), params=icp_params,
                      target_normals=src_nrm)
        cyc = se3.log(res.T @ res_rev.T)
        accept = (accept
                  & (torch.linalg.vector_norm(cyc[:, :3], dim=1)
                     <= params.max_cycle_t)
                  & (torch.linalg.vector_norm(cyc[:, 3:], dim=1)
                     <= params.max_cycle_r)
                  & (res_rev.error <= params.max_error))
    return res, accept
