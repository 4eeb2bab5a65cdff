"""Frozen copy of ``tpu_slam_torch.registration.icp``'s brute-force tier.

Point-to-point and point-to-plane ICP as Gauss-Newton on SE(3): each
iteration takes brute-force NN correspondences (the plain ``nn_search``),
Huber-weighted inliers within ``max_corr_dist``, the 6x6 normal equations,
and a left-multiplicative update T <- exp(xi) T. One pair or a batch of B
pairs (a leading dimension on the clouds, the normals and ``init_T``); the
batch keeps a per-pair ``active`` mask, so a finished pair's T,
iterations, error and matched fraction stop changing. The loop reads the
mask back after each iteration and stops when no pair is active.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from slambench.reference import se3
from slambench.reference.pointcloud import PointCloud
from slambench.reference.nn_search import nearest_neighbors
from slambench.reference.robust import huber_weight


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """Static ICP configuration (the reference's fields). ``nn_impl``
    selected the reference's TPU or XLA NN tier; the port has one NN path
    and ignores it."""

    max_iterations: int = 30
    tolerance: float = 1e-4          # stop when ||xi|| drops below this
    max_corr_dist: float = 1.0       # reject correspondences farther than this
    huber_delta: float = 0.5         # robust kernel width (meters)
    point_to_plane: bool = False
    damping: float = 1e-6            # Levenberg-style diagonal damping
    nn_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor                 # (..., 4, 4) source -> target transform
    iterations: torch.Tensor        # (...,) int32, GN iterations executed
    error: torch.Tensor             # mean squared residual over inliers
    matched_fraction: torch.Tensor  # inliers / valid source points
    converged: torch.Tensor         # bool


def _gn_point_to_point(src_w, tgt_pts, weights):
    """H (B, 6, 6), b (B, 6), err (B,) for r = p - q, J = [I | -hat(p)]."""
    eye = torch.eye(3, dtype=src_w.dtype, device=src_w.device)
    J = torch.cat([eye.expand(src_w.shape + (3,)), -se3.hat(src_w)],
                  dim=-1)                                  # (B, N, 3, 6)
    r = src_w - tgt_pts
    Jw = J * weights[..., None, None]
    H = torch.einsum("bnij,bnik->bjk", Jw, J)
    b = torch.einsum("bnij,bni->bj", Jw, r)
    err = torch.sum(weights * torch.sum(r * r, dim=-1), dim=-1)
    return H, b, err


def _gn_point_to_plane(src_w, tgt_pts, tgt_normals, weights):
    """H, b, err for r = n . (p - q), J = n^T [I | -hat(p)]."""
    Jr = -torch.einsum("bni,bnij->bnj", tgt_normals, se3.hat(src_w))
    J = torch.cat([tgt_normals, Jr], dim=-1)               # (B, N, 6)
    r = torch.sum(tgt_normals * (src_w - tgt_pts), dim=-1)
    H = torch.einsum("bni,bnj->bij", J * weights[..., None], J)
    b = torch.sum(J * (weights * r)[..., None], dim=-2)
    err = torch.sum(weights * r * r, dim=-1)
    return H, b, err


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, C) gathered at idx (B, N) -> (B, N, C)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                          x.shape[-1]))


def icp(source: PointCloud, target: PointCloud,
        init_T: Optional[torch.Tensor] = None,
        params: ICPParams = ICPParams(),
        target_normals: Optional[torch.Tensor] = None) -> ICPResult:
    """Register ``source`` onto ``target``; returns T with T @ source ~ target.

    One pair: points (N, 3) / (M, 3), init_T (4, 4). A batch: (B, N, 3) /
    (B, M, 3), init_T (B, 4, 4) or (4, 4); the result then has a leading B.
    For point-to-plane, pass per-target-point normals of the target's
    shape.
    """
    if params.point_to_plane and target_normals is None:
        raise ValueError("point_to_plane ICP requires target_normals")
    return _icp_body(source, target, init_T, target_normals, params)


def _icp_body(source: PointCloud, target: PointCloud,
              init_T: Optional[torch.Tensor],
              target_normals: Optional[torch.Tensor], params: ICPParams
              ) -> ICPResult:
    """``icp``'s solve: every update gated on the per-pair ``active``
    mask, read back after each iteration; stops once no pair is active."""
    single = source.points.dim() == 2
    src = source.sanitize()
    src_pts = src.points[None] if single else src.points
    src_msk = src.mask[None] if single else src.mask
    tgt_pts = target.sanitize().points
    tgt_pts = tgt_pts[None] if single else tgt_pts
    nrm = target_normals
    if nrm is not None and single:
        nrm = nrm[None]
    dev, dtype = src_pts.device, src_pts.dtype
    B = src_pts.shape[0]
    if init_T is None:
        init_T = torch.eye(4, dtype=dtype, device=dev)
    T = init_T.to(dtype).expand(B, 4, 4).clone()
    n_valid = torch.clamp(src_msk.sum(dim=-1, dtype=dtype), min=1.0)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    it = torch.zeros(B, dtype=torch.int32, device=dev)
    dx = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    err = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    frac = torch.zeros(B, dtype=dtype, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(params.max_iterations):
        src_w = se3.apply(T, src_pts)
        idx, dist = nearest_neighbors(src_w, tgt_pts)
        matched = _take_rows(tgt_pts, idx)
        inlier = src_msk & (dist < params.max_corr_dist)
        w = inlier.to(dtype) * huber_weight(dist, params.huber_delta)
        if params.point_to_plane:
            H, b, e = _gn_point_to_plane(src_w, matched,
                                         _take_rows(nrm, idx), w)
        else:
            H, b, e = _gn_point_to_point(src_w, matched, w)
        wsum = torch.clamp(w.sum(dim=-1), min=1e-6)
        trace = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + (params.damping * trace / 6.0)[:, None, None] * eye6
        # solve_ex: no error check (no host sync); a singular system (too
        # few inliers) gives non-finite entries, zeroed as the reference does
        xi = -torch.linalg.solve_ex(H, b)[0]
        xi = torch.where(torch.isfinite(xi), xi, 0.0)
        T = torch.where(active[:, None, None], se3.retract(T, xi), T)
        it = it + active.to(torch.int32)
        dx = torch.where(active, torch.linalg.vector_norm(xi, dim=-1), dx)
        err = torch.where(active, e / wsum, err)
        frac = torch.where(active, inlier.sum(dim=-1, dtype=dtype) / n_valid,
                           frac)
        active = active & (dx > params.tolerance)
        if not bool(active.any()):
            break
    res = ICPResult(T=T, iterations=it, error=err, matched_fraction=frac,
                    converged=dx <= params.tolerance)
    if single:
        res = ICPResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(res)})
    return res


