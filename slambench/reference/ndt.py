"""Frozen copy of ``tpu_slam_torch.registration.ndt``'s dense-window path.

The scan is binned into the field window once per solve stage (frozen
bins, live gate), every Levenberg-Marquardt evaluation is one plain NDT
terms pass (``ndt_terms``), and the solve runs a yaw-candidate search, a
graduated-non-convexity coarse stage re-binned every iteration, then the
fine stage re-binned every ``rebin_iters`` iterations, with an optional far
tier (scan points outside the fine window scored against a wider, coarser
field). The LM loops exit on host reads of their conditions
(``lm_schedule``'s host-exit form).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from slambench.reference import se3
from slambench.reference.pointcloud import PointCloud
from slambench.reference.voxel_hash import VoxelGridSpec


@dataclasses.dataclass(frozen=True)
class NDTParams:
    """Static NDT solve configuration (the reference's fields; its TPU
    gather-tier knobs have no counterpart here)."""

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
    window_bits: int = 6             # dense cube window: 2^window_bits
                                     # cells a side (when window_dims is
                                     # None and the grid has >= 16)
    window_dims: Optional[Tuple[int, int, int]] = None  # dense window
    terms_impl: str = "auto"         # "auto": dense window and the terms
                                     # kernel; "xla": the sparse path
    raster_q: int = 4                # per-cell point capacity of the bins
    yaw_candidates: int = 0          # headings tried before the coarse stage
    yaw_span: float = 0.3            # half-range of the yaw search (rad)
    motion_prior_weight: float = 0.0  # w I added to H, pulling to init_T
    rebin_iters: int = 4             # fine stage re-bins every this many



@dataclasses.dataclass(frozen=True)
class NDTField:
    """The dense field window: ``rows`` (G, 16) x-major [mean world (3),
    information upper triangle (6), valid, pad (6)], its corner cell and
    dims."""

    rows: Optional[torch.Tensor] = None
    origin_cell: Optional[torch.Tensor] = None   # (3,) int32 window corner
    window_dims: Optional[Tuple[int, int, int]] = None


@dataclasses.dataclass(frozen=True)
class NDTResult:
    T: torch.Tensor
    iterations: "int | torch.Tensor"   # a () int32 tensor when sync-free
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
    """Register a source cloud against a dense NDT field window.

    Levenberg-Marquardt with accept/reject on the NDT objective. With
    ``far_field``/``far_spec``, source points whose fine-window cell at the
    stage-entry pose is outside the window are binned into the far field's
    window and their terms added to the same H and b.
    """
    from slambench.reference.ndt_terms import build_terms_raster, ndt_terms

    if params.isotropic_iterations > 0 or not params.use_neighborhood:
        raise ValueError("the dense path needs use_neighborhood and no "
                         "isotropic stage")
    dev = source.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    src = source.sanitize()
    n_src_pts = torch.clamp(src.mask.sum(dtype=f32), min=1.0)
    q = params.raster_q
    dims = field.window_dims
    use_far = far_field is not None
    origin_w = (spec.origin_tensor(dev)
                + field.origin_cell.to(f32) * spec.leaf)
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

    def kernel_terms(T, gamma, raster):
        fine, far = raster
        H, b, cost, cnt = ndt_terms(fine, field.rows, T, gamma,
                                    params.max_corr_dist, dims)
        if far is not None:
            Hf, bf, costf, cntf = ndt_terms(far, far_field.rows, T, gamma,
                                            far_corr, far_field.window_dims)
            H, b = H + Hf, b + bf
            cost, cnt = cost + costf, cnt + cntf
        return H, b, cost, cnt / n_src_pts

    def yaw_cost(Ty, gamma_y):
        fine, _ = bin_raster(Ty, with_far=False)
        return ndt_terms(fine, field.rows, Ty, gamma_y, params.max_corr_dist,
                         dims)[2]

    T, iters, frac, cost, dx = lm_schedule(init_T, params, True, kernel_terms,
                                           bin_raster, yaw_cost)
    return NDTResult(T=T, iterations=iters, score=-cost / n_src_pts,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)


def lm_schedule(init_T: torch.Tensor, params: NDTParams, use_kernel: bool,
                raw_terms, bin_raster, yaw_cost, sync_free: bool = False):
    """The solve schedule of ``ndt_register``, over callables.

    ``raw_terms(T, gamma, ctx)`` gives (H, b, cost, matched fraction) at T
    (ctx: the stage's raster on the kernel path, the isotropic flag on the
    sparse one); ``bin_raster(T)`` bins the scan at a stage-entry pose;
    ``yaw_cost(T, gamma)`` scores a yaw candidate. Runs the yaw search and
    the coarse stage (kernel path), the isotropic stage (sparse path) and
    the fine stage, with the motion prior added to every evaluation.
    Returns (T, iterations, frac, cost, dx).

    Host-exit form (``sync_free=False``): the loops exit on host reads of
    values the callables returned, so callables that return the same bits
    on several ranks keep those ranks in lockstep; ``iterations`` is an
    int. Sync-free form: an LM solve runs exactly ``max_iters`` trips and a
    staged solve exactly its stage count, each trip updating the solve
    only while the reference's ``while_loop`` condition holds (computed on
    the device; a frozen trip's values, NaN included, are masked away), so
    nothing is read back; ``iterations`` is a () int32 tensor. Both forms
    give the same T, cost, frac, dx and iterations, bit for bit.
    """
    dev = init_T.device
    f32 = torch.float32
    eye6 = torch.eye(6, dtype=f32, device=dev)
    w_prior = _f32(params.motion_prior_weight)
    init_T_inv = se3.inverse(init_T)

    def terms(T, gamma, ctx):
        """The path's terms at T, plus the prior."""
        H, b, cost, frac = raw_terms(T, gamma, ctx)
        if w_prior > 0.0:
            xi_e = se3.log(se3.compose(T, init_T_inv))
            H = H + w_prior * eye6
            b = b + w_prior * xi_e
            cost = cost + 0.5 * w_prior * torch.sum(xi_e * xi_e)
        return H, b, cost, frac

    def lm_solve(T0, gamma, max_iters, tol, ctx, live=None):
        """``live`` (sync-free form): a () bool; False freezes the solve."""
        H, b, cost, frac = terms(T0, gamma, ctx)
        T = T0
        lam = torch.full((), 1e-4, dtype=f32, device=dev)
        dx = torch.full((), math.inf, dtype=f32, device=dev)
        it = (torch.zeros((), dtype=torch.int32, device=dev) if sync_free
              else 0)
        for _ in range(max_iters):
            active = (dx > tol) & (lam < 1e6)
            if not sync_free and not bool(active.item()):
                break
            if live is not None:
                active = active & live
            damp = lam * torch.clamp(torch.trace(H) / 6.0, min=1e-6)
            xi, info = torch.linalg.solve_ex(H + damp * eye6, b)
            xi = -xi
            xi = torch.where(torch.isfinite(xi) & (info == 0), xi, 0.0)
            T_try = se3.retract(T, xi)
            H_t, b_t, cost_t, frac_t = terms(T_try, gamma, ctx)
            better = cost_t < cost
            accept = better & active if sync_free else better
            T = torch.where(accept, T_try, T)
            lam_n = torch.where(better, torch.clamp(lam / 3.0, min=1e-7),
                                lam * 5.0)
            lam = torch.where(active, lam_n, lam) if sync_free else lam_n
            cost = torch.where(accept, cost_t, cost)
            H = torch.where(accept, H_t, H)
            b = torch.where(accept, b_t, b)
            frac = torch.where(accept, frac_t, frac)
            dx = torch.where(accept, torch.linalg.vector_norm(xi), dx)
            it = it + (active.to(torch.int32) if sync_free else 1)
        return T, cost, frac, it, dx

    def staged_solve(T0, gamma, n_iters, iters_per_stage, tol):
        """Kernel path: re-binned LM, binning at the current pose at every
        stage entry; convergence (dx <= tol) skips the remaining stages."""
        n_stages = -(-n_iters // iters_per_stage)
        T = T0
        it = (torch.zeros((), dtype=torch.int32, device=dev) if sync_free
              else 0)
        frac = torch.zeros((), dtype=f32, device=dev)
        cost = torch.full((), math.inf, dtype=f32, device=dev)
        dx = torch.full((), math.inf, dtype=f32, device=dev)
        for _ in range(n_stages):
            live = dx > tol
            if not sync_free and not bool(live.item()):
                break
            T2, cost2, frac2, it2, dx2 = lm_solve(
                T, gamma, iters_per_stage, tol, bin_raster(T),
                live if sync_free else None)
            if sync_free:
                T2 = torch.where(live, T2, T)
                cost2 = torch.where(live, cost2, cost)
                frac2 = torch.where(live, frac2, frac)
                dx2 = torch.where(live, dx2, dx)
            T, cost, frac, dx = T2, cost2, frac2, dx2
            it = it + it2
        return T, it, frac, cost, dx

    gamma_f = _f32(params.score_temperature)
    T_c, it_c = init_T, 0
    if use_kernel and params.yaw_candidates > 1:
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
            costs.append(yaw_cost(Ty, gamma_y))
            Tys.append(Ty)
        # a gather, not an index by a () tensor (that reads it back)
        best = torch.argmin(torch.stack(costs)).reshape(1)
        T_c = torch.index_select(torch.stack(Tys), 0, best)[0]
    if params.isotropic_iterations > 0:
        # stage 0 (sparse path): point-to-mean pull, a basin independent of
        # the Gaussians' shapes
        T_c, _, _, it0, _ = lm_solve(T_c, gamma_f,
                                     params.isotropic_iterations,
                                     10.0 * params.tolerance, True)
        it_c = it_c + it0
    if params.coarse_iterations > 0 and params.coarse_temperature_scale > 1.0:
        gamma_c = _f32(gamma_f * params.coarse_temperature_scale)
        if use_kernel:
            T_c, it1, _, _, _ = staged_solve(T_c, gamma_c,
                                             params.coarse_iterations, 1,
                                             10.0 * params.tolerance)
        else:
            T_c, _, _, it1, _ = lm_solve(T_c, gamma_c,
                                         params.coarse_iterations,
                                         10.0 * params.tolerance, False)
        it_c = it_c + it1

    if use_kernel:
        T, iters, frac, cost, dx = staged_solve(
            T_c, gamma_f, params.max_iterations, max(1, params.rebin_iters),
            params.tolerance)
    else:
        T, cost, frac, iters, dx = lm_solve(T_c, gamma_f,
                                            params.max_iterations,
                                            params.tolerance, False)
    return T, iters + it_c, frac, cost, dx
