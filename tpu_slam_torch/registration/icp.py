"""Point-to-point and point-to-plane ICP as Gauss-Newton on SE(3).

Port of ``tpu_slam.registration.icp``, in two tiers. ``icp``, the brute
force tier: each iteration takes brute-force NN correspondences
(``kernels.nn_search``, the CUDA kernel on the card), Huber-weighted inliers
within ``max_corr_dist``, the 6x6 normal equations, and a
left-multiplicative update T <- exp(xi) T. ``icp_raster``, the raster tier
for one pair: both clouds binned into a window once a stage, and each
iteration one fused terms pass (``kernels.icp_terms``). ``icp_auto`` routes
a pair by its size.

``icp`` takes one pair or a batch of B pairs (a leading dimension on the
clouds, the normals and ``init_T``), where the reference ``jax.vmap``s its
``while_loop``. The batch keeps a per-pair ``active`` mask: a finished
pair's T, iterations, error and matched fraction stop changing, so each
pair ends exactly where its own loop would.

Both solves are the reference's compiled programs (``icp`` one
``jax.jit`` with a ``while_loop``, ``icp_raster`` one with two). With
``compiled=True`` (the default) each runs its sync-free form, a fixed trip
count (``icp``: max_iterations trips; ``icp_raster``: each stage's bound)
that freezes a solve on the device once the reference's loop condition
fails: one CUDA graph replay on a CUDA device (cached by the inputs'
signature and the static arguments), eagerly on the CPU.
``compiled=False`` runs the host-exit form, which reads the mask (``icp``)
or the step norm (``icp_raster``) back after every iteration and stops
when nothing is left to do. Both count the reference's iterations and
give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.consts import const
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.icp_terms import icp_terms_raster
from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                              raster_to_slots)
from tpu_slam_torch.kernels.nn_search import nearest_neighbors
from tpu_slam_torch.registration.robust import huber_weight
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import CapturedCall, replay

# icp_auto's default: the brute tier below this many points, the raster tier
# at or above it. chip_smoke.py's pair_icp phase on an H100, with the
# redesigned NN kernel (0.65x the earlier one's device time at 64k-128k),
# measured the brute tier ahead at 8k-64k points (1.8x at 64k), the two
# level at 128k (raster 20.8, brute 20.0 registrations/s; the host-bound
# raster tier's rate moves by up to 1.6x between machines) and the raster
# tier ahead at 256k (4.6x): 96k still splits the bracket (PERF.md)
AUTO_CROSSOVER = 98304


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


# the captured icp programs, by their inputs' signature and static args
_batches: Dict[Tuple, CapturedCall] = {}


def icp(source: PointCloud, target: PointCloud,
        init_T: Optional[torch.Tensor] = None,
        params: ICPParams = ICPParams(),
        target_normals: Optional[torch.Tensor] = None,
        compiled: bool = True) -> ICPResult:
    """Register ``source`` onto ``target``; returns T with T @ source ~ target.

    One pair: points (N, 3) / (M, 3), init_T (4, 4). A batch: (B, N, 3) /
    (B, M, 3), init_T (B, 4, 4) or (4, 4); the result then has a leading B.
    For point-to-plane, pass per-target-point normals of the target's
    shape. ``compiled``: see the module docstring.
    """
    if params.point_to_plane and target_normals is None:
        raise ValueError("point_to_plane ICP requires target_normals")
    if not compiled or source.points.device.type != "cuda":
        res = _icp_body(source, target, init_T, target_normals, params,
                        sync_free=compiled)
    else:
        def body(src, tgt, T0, nrm):
            return _icp_body(src, tgt, T0, nrm, params, sync_free=True)

        res = replay(_batches, body,
                     (PointCloud(source.points, source.mask),
                      PointCloud(target.points, target.mask), init_T,
                      target_normals),
                     static=(params,), counters=(nearest_neighbors,))
    if compiled:
        pairs = 1 if source.points.dim() == 2 else source.points.shape[0]
        tracing.count("icp_trips_run", pairs * params.max_iterations)
    return res


def _icp_body(source: PointCloud, target: PointCloud,
              init_T: Optional[torch.Tensor],
              target_normals: Optional[torch.Tensor], params: ICPParams,
              sync_free: bool) -> ICPResult:
    """``icp``'s solve. Both forms gate every update on the per-pair
    ``active`` mask; the host-exit form reads it back after each iteration
    and stops once no pair is active, the sync-free form runs all
    max_iterations trips. The iterations summed over the pairs go to the
    device counter ``icp_trips_used``, and the host-exit form's trips
    times the pairs to the host counter ``icp_trips_run`` (``icp`` counts
    the sync-free form's)."""
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
        if not sync_free:
            tracing.count("icp_trips_run", B)
            if not bool(active.any()):
                break
    tracing.device_count("icp_trips_used", it.sum())
    res = ICPResult(T=T, iterations=it, error=err, matched_fraction=frac,
                    converged=dx <= params.tolerance)
    if single:
        res = ICPResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(res)})
    return res


@dataclasses.dataclass(frozen=True)
class RasterProblem:
    """A pair solve of ``icp_raster`` in its own axes (permuted when
    ``axis_perm`` is given): the sanitized source, the target binned once
    at the identity into the dense (G*Qt, 4) slot table, the window origin
    and the initial pose, and the permutation matrix (or None)."""

    source: PointCloud
    tgt_table: torch.Tensor
    origin: torch.Tensor
    init_T: torch.Tensor
    perm: Optional[torch.Tensor]


def raster_problem(source: PointCloud, target: PointCloud,
                   init_T: Optional[torch.Tensor], dims: tuple, leaf: float,
                   qt: int, origin_world: Optional[torch.Tensor] = None,
                   axis_perm: Optional[tuple] = None) -> RasterProblem:
    """Set up a pair solve of ``icp_raster``; see there."""
    src, tgt = source.sanitize(), target.sanitize()
    dev = src.points.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    init_T = init_T.to(device=dev, dtype=torch.float32)
    Pi = None
    if axis_perm is not None:
        # a proper rotation: the solve runs in permuted coordinates and the
        # result is conjugated back
        perm = list(axis_perm)
        Pi = const([float(col == c) for col in perm + [3] for c in range(4)],
                   torch.float32, dev).reshape(4, 4)
        # the columns by a device index (a list index is copied from the
        # host at every call)
        cols = const(perm, torch.long, dev)
        src = PointCloud(points=src.points.index_select(1, cols),
                         mask=src.mask)
        tgt = PointCloud(points=tgt.points.index_select(1, cols),
                         mask=tgt.mask)
        init_T = Pi @ init_T @ Pi.T
    if origin_world is None:
        # centred on the target centroid, on the leaf grid; torch.round
        # rounds half to even, as jnp.round does
        tw = tgt.mask.sum(dtype=torch.float32)
        cen = (torch.where(tgt.mask[:, None], tgt.points, 0.0).sum(dim=0)
               / torch.clamp(tw, min=1.0))
        half = const([d * leaf / 2 for d in dims], torch.float32, dev)
        origin_world = torch.round((cen - half) / leaf) * leaf
    origin_world = origin_world.to(device=dev, dtype=torch.float32)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    slots, _ = build_terms_raster(tgt.points, tgt.mask, eye, origin_world,
                                  leaf, dims, qt)
    return RasterProblem(source=src,
                         tgt_table=raster_to_slots(slots, dims, qt),
                         origin=origin_world, init_T=init_T, perm=Pi)


# the captured icp_raster programs, by their inputs' signature and static
# args
_rasters: Dict[Tuple, CapturedCall] = {}


def icp_raster(source: PointCloud, target: PointCloud,
               init_T: Optional[torch.Tensor] = None,
               params: ICPParams = ICPParams(),
               dims: tuple = (32, 32, 16), leaf: float = 0.5,
               qs: int = 8, qt: int = 8,
               origin_world: Optional[torch.Tensor] = None,
               axis_perm: Optional[tuple] = None,
               compiled: bool = True) -> ICPResult:
    """Pair ICP on the fused raster terms kernel (``kernels.icp_terms``).

    The target is binned once (world frame, at the identity), the source at
    the stage-entry pose; every GN iteration is then ONE pass fusing the
    27-neighbourhood correspondence search, Huber weighting and the 6x6
    reduction. Exact NN within one ``leaf``, so pick leaf >= the expected
    initial displacement (the brute-force ``icp`` covers any displacement).

    ``dims`` x ``leaf`` must cover both clouds around ``origin_world``
    (default: centred on the target centroid); points outside the window
    or beyond the per-cell capacity ``qs``/``qt`` drop out of the objective
    and count against the matched fraction. ``axis_perm`` (e.g. (2, 0, 1),
    world z on window x) runs the solve in permuted axes; ``dims`` and
    ``origin_world`` are then given in the permuted space.

    Two stages with a re-bin between: the first (max_iterations // 2, at
    least 1) absorbs the initial error, the second re-bins the source at
    the refined pose and runs on to max_iterations in all. ``compiled``
    (see the module docstring): the captured sync-free form on a CUDA
    device, that form eagerly on the CPU; else the host-exit form.
    """
    if not compiled:
        return _icp_raster_body(source, target, init_T, origin_world, params,
                                dims, leaf, qs, qt, axis_perm,
                                sync_free=False)
    dev = source.points.device
    init_T = (torch.eye(4, dtype=torch.float32, device=dev) if init_T is None
              else init_T.to(device=dev, dtype=torch.float32))
    if origin_world is not None:
        origin_world = origin_world.to(device=dev, dtype=torch.float32)
    if dev.type != "cuda":
        return _icp_raster_body(source, target, init_T, origin_world, params,
                                dims, leaf, qs, qt, axis_perm,
                                sync_free=True)

    def body(src, tgt, T0, origin):
        return _icp_raster_body(src, tgt, T0, origin, params, dims, leaf, qs,
                                qt, axis_perm, sync_free=True)

    return replay(_rasters, body,
                  (PointCloud(source.points, source.mask),
                   PointCloud(target.points, target.mask), init_T,
                   origin_world),
                  static=(params, dims, leaf, qs, qt, axis_perm),
                  counters=(icp_terms_raster,))


def _icp_raster_body(source: PointCloud, target: PointCloud,
                     init_T: Optional[torch.Tensor],
                     origin_world: Optional[torch.Tensor],
                     params: ICPParams, dims: tuple, leaf: float, qs: int,
                     qt: int, axis_perm: Optional[tuple],
                     sync_free: bool) -> ICPResult:
    """``icp_raster``'s solve. Host-exit form: each stage's loop reads
    ``dx > tolerance`` back after every iteration. Sync-free form: stage
    one runs max(1, max_iterations // 2) trips and stage two
    max_iterations, each trip updating the solve only while the
    reference's condition (it < the stage's bound and dx > tolerance)
    holds, so nothing is read back and ``iterations`` counts what the
    reference's loops count."""
    prob = raster_problem(source, target, init_T, dims, leaf, qt,
                          origin_world, axis_perm)
    src = prob.source
    dev = src.points.device
    n_valid = torch.clamp(src.mask.sum(dtype=torch.float32), min=1.0)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def gn_step(slots, T):
        H, b, e, nmatch, wsum = icp_terms_raster(
            slots, prob.tgt_table, T, params.max_corr_dist,
            params.huber_delta, dims, qs, qt)
        H = H + params.damping * torch.trace(H) / 6.0 * eye6
        # solve_ex: no host sync; a singular system gives non-finite
        # entries, zeroed as the reference does
        xi = -torch.linalg.solve_ex(H, b)[0]
        xi = torch.where(torch.isfinite(xi), xi, 0.0)
        return (se3.retract(T, xi), torch.linalg.vector_norm(xi),
                e / torch.clamp(wsum, min=1e-6), nmatch / n_valid)

    def solve_stage(T0, max_iters, it):
        slots, _ = build_terms_raster(src.points, src.mask, T0, prob.origin,
                                      leaf, dims, qs)
        T = T0
        inf = torch.full((), float("inf"), device=dev)
        dx, err, frac = inf, inf, torch.zeros((), device=dev)
        if sync_free:
            for _ in range(max_iters):
                active = (it < max_iters) & (dx > params.tolerance)
                T_n, dx_n, err_n, frac_n = gn_step(slots, T)
                T = torch.where(active, T_n, T)
                dx = torch.where(active, dx_n, dx)
                err = torch.where(active, err_n, err)
                frac = torch.where(active, frac_n, frac)
                it = it + active.to(torch.int32)
            return T, it, dx, err, frac
        while it < max_iters:
            T, dx, err, frac = gn_step(slots, T)
            it += 1
            if not bool(dx > params.tolerance):
                break
        return T, it, dx, err, frac

    it0 = (torch.zeros((), dtype=torch.int32, device=dev) if sync_free
           else 0)
    T, it, _, _, _ = solve_stage(prob.init_T,
                                 max(1, params.max_iterations // 2), it0)
    T, it, dx, err, frac = solve_stage(T, params.max_iterations, it)
    if prob.perm is not None:
        T = prob.perm.T @ T @ prob.perm
    if not sync_free:
        it = torch.full((), it, dtype=torch.int32, device=dev)
    return ICPResult(T=T, iterations=it, error=err, matched_fraction=frac,
                     converged=dx <= params.tolerance)


def icp_auto(source: PointCloud, target: PointCloud,
             init_T: Optional[torch.Tensor] = None,
             params: ICPParams = ICPParams(),
             crossover: int = AUTO_CROSSOVER, compiled: bool = True,
             **raster_kwargs) -> ICPResult:
    """Size-routed pair ICP: brute-force ``icp`` under ``crossover`` points
    (the source's capacity), ``icp_raster`` at or above it, each compiled
    (its default).

    The brute tier's NN pass is O(N^2) an iteration, the raster tier's
    pass ~O(N) plus a binning a stage. ``raster_kwargs`` (dims, leaf,
    origin_world, axis_perm, qs, qt) configure the raster tier.
    """
    if source.capacity < crossover:
        return icp(source, target, init_T=init_T, params=params,
                   compiled=compiled)
    return icp_raster(source, target, init_T=init_T, params=params,
                      compiled=compiled, **raster_kwargs)
