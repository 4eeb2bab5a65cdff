"""NDT (normal-distributions transform) scan-to-map registration.

Port of the kernel path of ``tpu_slam.registration.ndt``: the scan is binned
into the dense field window once per solve stage (frozen bins, live gate),
every Levenberg-Marquardt evaluation is one NDT terms pass
(``kernels.ndt_terms``), and the solve runs

  1. a yaw-candidate search (one bin + one pass per candidate heading),
  2. a graduated-non-convexity coarse stage at a raised temperature,
     re-binned every iteration,
  3. the fine stage, re-binned every ``rebin_iters`` iterations,

with an optional far tier (scan points outside the fine window scored
against a wider, coarser field) and an optional motion prior toward the
init pose.

The reference's ``lax.while_loop``s exit on data; here they are host loops
that read the exit condition with one ``.item()`` per iteration, so
``iterations`` counts exactly the iterations the reference counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec


@dataclasses.dataclass(frozen=True)
class NDTParams:
    """Static NDT solve configuration (the reference's fields that steer the
    kernel path; its TPU gather-tier knobs have no counterpart here)."""

    max_iterations: int = 30
    tolerance: float = 1e-4
    use_neighborhood: bool = True    # 3x3x3-aggregated Gaussians
    min_voxel_count: float = 5.0
    evec_floor_ratio: float = 0.01   # eigenvalue floor vs largest
    max_corr_dist: float = 1.0       # Euclidean gate on |p - mu| (m)
    score_temperature: float = 4.0   # gamma in exp(-d2 / (2 gamma))
    coarse_temperature_scale: float = 16.0  # GNC stage-1 gamma multiplier
    coarse_iterations: int = 10      # LM iterations of the coarse stage
    isotropic_iterations: int = 0    # point-to-mean stage (sparse path only)
    window_dims: Optional[Tuple[int, int, int]] = None  # dense window
    raster_q: int = 4                # per-cell point capacity of the bins
    yaw_candidates: int = 0          # headings tried before the coarse stage
    yaw_span: float = 0.3            # half-range of the yaw search (rad)
    motion_prior_weight: float = 0.0  # w I added to H, pulling to init_T
    rebin_iters: int = 4             # fine stage re-bins every this many


@dataclasses.dataclass(frozen=True)
class NDTField:
    """Solver-ready dense field window: per-cell rows (G, 16) x-major
    [mean world (3), information upper triangle (6), valid, pad (6)]."""

    rows: torch.Tensor
    origin_cell: torch.Tensor                # (3,) int32 window corner
    window_dims: Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class NDTResult:
    T: torch.Tensor
    iterations: int
    score: torch.Tensor               # -cost / valid source points
    matched_fraction: torch.Tensor
    converged: torch.Tensor


def _shift0(x: torch.Tensor, delta: int, axis: int) -> torch.Tensor:
    """x shifted so out[i] = x[i + delta] along ``axis``, zero-filled."""
    if delta == 0:
        return x
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if delta > 0:
        out.narrow(axis, 0, n - delta).copy_(x.narrow(axis, delta, n - delta))
    else:
        out.narrow(axis, -delta, n + delta).copy_(x.narrow(axis, 0, n + delta))
    return out


def _nbr_moment_pass(a: torch.Tensor, axis: int, t: float) -> torch.Tensor:
    """One separable 3x3x3 moment-aggregation pass along ``axis``.

    ``a`` is (Wx, Wy, Wz, 10) [n, s(3), outer-triu(6)] about each cell's
    corner; the neighbour at offset d contributes its moments re-expressed
    about the receiving cell's corner (displacement t*d):
    s' = s + n d,  o' = o + d s^T + s d^T + n d d^T. The three axis passes
    compose to the full 27-cell sum.
    """
    # channel layout: 0 n, 1..3 s, 4 oxx, 5 oxy, 6 oxz, 7 oyy, 8 oyz, 9 ozz
    diag = {0: 4, 1: 7, 2: 9}[axis]
    off = {0: (5, 6), 1: (5, 8), 2: (6, 8)}[axis]
    other = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[axis]

    def shifted(delta: int) -> torch.Tensor:
        v = _shift0(a, delta, axis)
        if delta == 0:
            return v
        d = t * delta
        n_ = v[..., 0]
        s_a = v[..., 1 + axis]
        out = [n_]
        for c in range(3):
            out.append(v[..., 1 + c] + d * n_ if c == axis else v[..., 1 + c])
        o = {k: v[..., k] for k in range(4, 10)}
        o[diag] = o[diag] + 2.0 * d * s_a + n_ * d * d
        o[off[0]] = o[off[0]] + d * v[..., 1 + other[0]]
        o[off[1]] = o[off[1]] + d * v[..., 1 + other[1]]
        return torch.stack(out + [o[k] for k in range(4, 10)], dim=-1)

    return shifted(-1) + shifted(0) + shifted(1)


def _f32(x: float) -> float:
    """Round a host scalar to float32 (the reference computes these in f32)."""
    return float(np.float32(x))


def ndt_register(source: PointCloud, field: NDTField, spec: VoxelGridSpec,
                 init_T: Optional[torch.Tensor] = None,
                 params: NDTParams = NDTParams(),
                 far_field: Optional[NDTField] = None,
                 far_spec: Optional[VoxelGridSpec] = None) -> NDTResult:
    """Register a source cloud against a dense NDT field (scan-to-map).

    Levenberg-Marquardt with accept/reject on the NDT objective. With
    ``far_field``/``far_spec``, source points whose fine-window cell at the
    stage-entry pose is outside the window are binned into the far field's
    window and their terms added to the same H and b.
    """
    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster, ndt_terms

    if params.isotropic_iterations > 0:
        raise ValueError("isotropic_iterations > 0 needs the sparse field "
                         "path, which is not ported; use the coarse pyramid "
                         "for large-init capture")
    if not params.use_neighborhood:
        raise ValueError("the dense kernel path needs use_neighborhood")
    dev = source.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    src = source.sanitize()
    n_src_pts = torch.clamp(src.mask.sum(dtype=f32), min=1.0)
    q = params.raster_q
    dims = field.window_dims
    origin_w = (spec.origin_tensor(dev)
                + field.origin_cell.to(f32) * spec.leaf)
    use_far = far_field is not None
    if use_far:
        far_origin_w = (far_spec.origin_tensor(dev)
                        + far_field.origin_cell.to(f32) * far_spec.leaf)
        far_corr = params.max_corr_dist * (far_spec.leaf / spec.leaf)

    def bin_raster(T0, with_far=True):
        fine, _ = build_terms_raster(src.points, src.mask, T0, origin_w,
                                     spec.leaf, dims, q)
        if not (use_far and with_far):
            return fine, None
        # far tier: ONLY the points whose fine-window cell at T0 is out of
        # range (in-window points are already in the fine objective)
        far, _ = build_terms_raster(src.points, src.mask & ~fine.inside, T0,
                                    far_origin_w, far_spec.leaf,
                                    far_field.window_dims, q)
        return fine, far

    eye6 = torch.eye(6, dtype=f32, device=dev)
    w_prior = _f32(params.motion_prior_weight)
    init_T_inv = se3.inverse(init_T)

    def terms(T, gamma, raster):
        fine, far = raster
        H, b, cost, cnt = ndt_terms(fine, field.rows, T, gamma,
                                    params.max_corr_dist, dims)
        if far is not None:
            Hf, bf, costf, cntf = ndt_terms(far, far_field.rows, T, gamma,
                                            far_corr, far_field.window_dims)
            H, b = H + Hf, b + bf
            cost, cnt = cost + costf, cnt + cntf
        frac = cnt / n_src_pts
        if w_prior > 0.0:
            xi_e = se3.log(se3.compose(T, init_T_inv))
            H = H + w_prior * eye6
            b = b + w_prior * xi_e
            cost = cost + 0.5 * w_prior * torch.sum(xi_e * xi_e)
        return H, b, cost, frac

    def lm_solve(T0, gamma, max_iters, tol, raster):
        H, b, cost, frac = terms(T0, gamma, raster)
        T = T0
        lam = torch.tensor(1e-4, dtype=f32, device=dev)
        dx = torch.tensor(math.inf, dtype=f32, device=dev)
        it = 0
        while it < max_iters and bool(((dx > tol) & (lam < 1e6)).item()):
            damp = lam * torch.clamp(torch.trace(H) / 6.0, min=1e-6)
            xi, info = torch.linalg.solve_ex(H + damp * eye6, b)
            xi = -xi
            xi = torch.where(torch.isfinite(xi) & (info == 0), xi, 0.0)
            T_try = se3.retract(T, xi)
            H_t, b_t, cost_t, frac_t = terms(T_try, gamma, raster)
            accept = cost_t < cost
            T = torch.where(accept, T_try, T)
            lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-7),
                              lam * 5.0)
            cost = torch.where(accept, cost_t, cost)
            H = torch.where(accept, H_t, H)
            b = torch.where(accept, b_t, b)
            frac = torch.where(accept, frac_t, frac)
            dx = torch.where(accept, torch.linalg.vector_norm(xi), dx)
            it += 1
        return T, cost, frac, it, dx

    def staged_solve(T0, gamma, n_iters, iters_per_stage, tol):
        """Re-binned LM: bin at the current pose at every stage entry;
        convergence (dx <= tol) skips the remaining stages."""
        n_stages = -(-n_iters // iters_per_stage)
        T, it = T0, 0
        frac = torch.zeros((), dtype=f32, device=dev)
        cost = torch.tensor(math.inf, dtype=f32, device=dev)
        dx = torch.tensor(math.inf, dtype=f32, device=dev)
        s = 0
        while s < n_stages and bool((dx > tol).item()):
            T, cost, frac, it2, dx = lm_solve(T, gamma, iters_per_stage, tol,
                                              bin_raster(T))
            it += it2
            s += 1
        return T, it, frac, cost, dx

    gamma_f = _f32(params.score_temperature)
    T_c, it_c = init_T, 0
    if params.yaw_candidates > 1:
        gamma_y = _f32(gamma_f * max(params.coarse_temperature_scale, 1.0))
        offs = torch.linspace(-params.yaw_span, params.yaw_span,
                              params.yaw_candidates, dtype=f32, device=dev)
        costs, Tys = [], []
        for k in range(params.yaw_candidates):
            c, s = torch.cos(offs[k]), torch.sin(offs[k])
            zero, one = torch.zeros_like(c), torch.ones_like(c)
            Rz = torch.stack([torch.stack([c, -s, zero, zero]),
                              torch.stack([s, c, zero, zero]),
                              torch.stack([zero, zero, one, zero]),
                              torch.stack([zero, zero, zero, one])])
            Ty = T_c @ Rz                   # rotate heading, keep position
            fine, _ = bin_raster(Ty, with_far=False)
            _, _, cost, _ = ndt_terms(fine, field.rows, Ty, gamma_y,
                                      params.max_corr_dist, dims)
            costs.append(cost)
            Tys.append(Ty)
        T_c = torch.stack(Tys)[torch.argmin(torch.stack(costs))]
    if params.coarse_iterations > 0 and params.coarse_temperature_scale > 1.0:
        gamma_c = _f32(gamma_f * params.coarse_temperature_scale)
        T_c, it1, _, _, _ = staged_solve(T_c, gamma_c,
                                         params.coarse_iterations, 1,
                                         10.0 * params.tolerance)
        it_c += it1

    T, iters, frac, cost, dx = staged_solve(
        T_c, gamma_f, params.max_iterations, max(1, params.rebin_iters),
        params.tolerance)
    return NDTResult(T=T, iterations=iters + it_c, score=-cost / n_src_pts,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)
