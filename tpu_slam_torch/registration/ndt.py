"""NDT (normal-distributions transform) scan-to-map registration.

Port of ``tpu_slam.registration.ndt``. Two paths, chosen by the field:

* the **kernel path** (a dense field window, ``NDTField.rows``): the scan
  is binned into the window once per solve stage (frozen bins, live gate),
  every Levenberg-Marquardt evaluation is one NDT terms pass
  (``kernels.ndt_terms``, the CUDA kernel on the card), and the solve runs
  a yaw-candidate search, a graduated-non-convexity coarse stage re-binned
  every iteration, then the fine stage re-binned every ``rebin_iters``
  iterations, with an optional far tier (scan points outside the fine
  window scored against a wider, coarser field);
* the **sparse path** (the map's per-voxel Gaussians, ``NDTField.means``
  / ``info`` / ``valid``): each point's 27 neighbour cells are found by
  binary search over the sorted keys and their Gaussians gathered, the
  terms summed by einsum; an optional isotropic (point-to-mean) stage,
  the coarse stage and the fine stage are plain LM solves.

``NDTParams.terms_impl`` picks the field ``ndt_field`` builds: "auto" the
dense window (``window_dims``, or the ``2^window_bits`` cube) on every
device, "xla" the sparse views. (The reference's "auto" takes the dense
window only on its accelerator and the sparse views elsewhere.) The
reference's dense-lookup, packed-row and neighbour-packed tiers of the
sparse path exist for the TPU's gather cost and are not ported: the
binary search finds the same slots.

The reference's ``lax.while_loop``s exit on data. ``lm_schedule`` has two
forms of them. The host-exit form reads the exit condition with one
``.item()`` an iteration. The sync-free form (``sync_free=True``, the
dense engine's compiled step) runs every loop for its full trip count and
freezes the solve on the device once the condition fails, reading nothing
back; both count exactly the iterations the reference counts and give the
same bits. ``compiled_register`` is the reference's compiled
``ndt_register`` (one ``jax.jit``): on a CUDA device it replays the
sync-free form as one CUDA graph (cached by the inputs' signature and the
static arguments), on the CPU it runs that form eagerly, and with
``compiled=False`` it runs the host-exit form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.consts import const
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.core.sym3 import floored_info_sym3
from tpu_slam_torch.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               cell_coords,
                                               neighbor_offsets_keys,
                                               pack_key)
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import CapturedCall, replay

TERMS_IMPLS = ("auto", "xla")


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

    def __post_init__(self):
        if self.terms_impl not in TERMS_IMPLS:
            raise ValueError(f"terms_impl={self.terms_impl!r}: the port has "
                             f"{TERMS_IMPLS}")


@dataclasses.dataclass(frozen=True)
class NDTField:
    """Solver-ready view of a map: either the dense field window (``rows``
    (G, 16) x-major [mean world (3), information upper triangle (6),
    valid, pad (6)], its corner cell and dims: the kernel path), or the
    sparse per-voxel views (``keys``, ``means``, ``info``, ``valid``: the
    sparse path)."""

    rows: Optional[torch.Tensor] = None
    origin_cell: Optional[torch.Tensor] = None   # (3,) int32 window corner
    window_dims: Optional[Tuple[int, int, int]] = None
    keys: Optional[torch.Tensor] = None      # (C,) int32 sorted map keys
    means: Optional[torch.Tensor] = None     # (C, 3) world frame
    info: Optional[torch.Tensor] = None      # (C, 3, 3) floored inverse
    valid: Optional[torch.Tensor] = None     # (C,) bool


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


def ndt_field(vmap, spec: VoxelGridSpec, params: NDTParams = NDTParams(),
              center: Optional[torch.Tensor] = None) -> NDTField:
    """The solver-ready NDT field of a sparse voxel map.

    With ``terms_impl="auto"`` and ``use_neighborhood``: the dense field
    window, ``window_dims`` or else the cube of ``2^min(dim_bits,
    window_bits)`` cells a side (when that is at least 16), for the kernel
    path. Otherwise the sparse views: each voxel's Gaussian from its
    27-neighbourhood moments (valid from ``min_voxel_count`` points), or
    from its own moments without ``use_neighborhood``, inverted with the
    eigenvalue floor (``floored_info_sym3``, no ``eigh``).
    """
    from tpu_slam_torch.mapping.voxel_map import (neighborhood_moments,
                                                  voxel_covariances,
                                                  voxel_means)

    kernel = params.terms_impl == "auto"
    if params.window_dims is not None:
        if not (kernel and params.use_neighborhood):
            raise ValueError("window_dims needs the kernel path: "
                             "terms_impl='auto' and use_neighborhood")
        return _ndt_field_dense(vmap, spec, params, params.window_dims,
                                center)
    wb = min(spec.dim_bits, params.window_bits)
    if kernel and params.use_neighborhood and wb >= 4:
        return _ndt_field_dense(vmap, spec, params, (1 << wb,) * 3, center)
    occ = vmap.occupied_mask()
    if params.use_neighborhood:
        cnt, means, cov = neighborhood_moments(vmap, spec)
        valid = occ & (cnt >= params.min_voxel_count)
    else:
        means = voxel_means(vmap, spec)
        cov = voxel_covariances(vmap, min_count=params.min_voxel_count,
                                regularization=0.0)
        valid = occ & (vmap.count >= params.min_voxel_count)
    return NDTField(keys=vmap.keys, means=means,
                    info=floored_info_sym3(cov, params.evec_floor_ratio),
                    valid=valid)


def _ndt_field_dense(vmap, spec: VoxelGridSpec, params: NDTParams,
                     window_dims: Tuple[int, int, int],
                     center: Optional[torch.Tensor]) -> NDTField:
    """The dense field window (the reference's ``_ndt_field_dense``).

    The voxels inside a (Wx, Wy, Wz) window are scattered into dense rows
    (one write a voxel, the dropped ones into a spare row), the 27-cell
    sums and floored inverses follow as in ``grid_ndt_field``, and a cell
    is valid where a voxel was scattered and the 27-cell count reaches
    ``min_voxel_count`` (counts floored at 1 in the division). The window
    corner is clip(floor((center - origin) / leaf) - dims // 2, 0,
    n - dims), ``center`` defaulting to the map's centroid; a window as
    large as the grid is the grid (corner 0).
    """
    from tpu_slam_torch.mapping.dense_map import field_rows
    from tpu_slam_torch.mapping.voxel_map import decode_corner

    b = spec.dim_bits
    n = spec.cells_per_axis
    dims = tuple(min(d, n) for d in window_dims)
    wx, wy, wz = dims
    g = wx * wy * wz
    dev = vmap.keys.device
    f32 = torch.float32
    occ = vmap.occupied_mask()
    keys = vmap.keys
    gx = (keys >> (2 * b)) & (n - 1)
    gy = (keys >> b) & (n - 1)
    gz = keys & (n - 1)

    if wx >= n and wy >= n and wz >= n:
        c0 = torch.zeros(3, dtype=torch.int32, device=dev)
    else:
        if center is None:
            # map centroid: corners weighted by count plus the local sums
            total = torch.clamp(torch.where(occ, vmap.count, 0.0).sum(),
                                min=1.0)
            corners = decode_corner(keys, spec)
            wsum = torch.where(occ[:, None],
                               corners * vmap.count[:, None] + vmap.sum_pts,
                               0.0).sum(dim=0)
            center = wsum / total
        cc = torch.floor((torch.as_tensor(center, dtype=f32, device=dev)
                          - spec.origin_tensor(dev)) / spec.leaf
                         ).to(torch.int32)
        half = const((wx // 2, wy // 2, wz // 2), torch.int32, dev)
        hi = const((n - wx, n - wy, n - wz), torch.int32, dev)
        c0 = torch.minimum(torch.clamp(cc - half, min=0), hi)
    lx, ly, lz = gx - c0[0], gy - c0[1], gz - c0[2]
    inside = (occ & (lx >= 0) & (lx < wx) & (ly >= 0) & (ly < wy)
              & (lz >= 0) & (lz < wz))
    lidx = torch.where(inside, (lx * wy + ly) * wz + lz, g).long()

    # [count, sum (3), outer upper triangle (6), occupied]; keys are unique,
    # so no two voxels write one row (the dropped ones write zeros to row G)
    so = vmap.sum_outer
    chan = torch.cat([
        vmap.count[:, None], vmap.sum_pts,
        so[:, 0, 0:1], so[:, 0, 1:2], so[:, 0, 2:3],
        so[:, 1, 1:2], so[:, 1, 2:3], so[:, 2, 2:3],
        torch.ones((vmap.capacity, 1), dtype=f32, device=dev)], dim=1)
    chan = torch.where(inside[:, None], chan, 0.0)
    dm = torch.zeros((g + 1, 11), dtype=f32, device=dev)
    dm[lidx] = chan
    dm = dm[:g]
    rows16 = field_rows(dm[:, :10], dm[:, 10] > 0.5, c0, dims, spec,
                        params.min_voxel_count, params.evec_floor_ratio,
                        count_floor=1.0)
    return NDTField(rows=rows16, origin_cell=c0, window_dims=dims)


def _f32(x: float) -> float:
    """Round a host scalar to float32 (the reference computes these in f32)."""
    return float(np.float32(x))


def _require_sparse_views(field: NDTField, who: str) -> None:
    if field.means is None:
        raise ValueError(f"{who} needs the sparse field views; this field "
                         "is a dense window (build it with "
                         "terms_impl='xla')")


def _probe_slots(field: NDTField, nkeys: torch.Tensor):
    """(..., 27) neighbour keys -> (slots, hit) by binary search over the
    field's sorted keys."""
    c = field.keys.shape[0]
    pos = torch.clamp(torch.searchsorted(field.keys, nkeys), 0, c - 1)
    hit = (field.keys[pos] == nkeys) & (nkeys != INVALID_KEY)
    return pos, hit


def _neighbour_slots(pts: torch.Tensor, field: NDTField,
                     spec: VoxelGridSpec):
    """Slots of each point's 27 neighbour cells and whether each holds a
    valid Gaussian: (pos (N, 27), ok (N, 27))."""
    nkeys = neighbor_offsets_keys(pack_key(cell_coords(pts, spec), spec),
                                  spec)
    pos, hit = _probe_slots(field, nkeys)
    return pos, hit & field.valid[pos]


def _ndt_correspond(pts: torch.Tensor, field: NDTField,
                    spec: VoxelGridSpec):
    """Best Gaussian of each point's 27-neighbourhood by Mahalanobis
    distance (the first on ties). Returns (mu (N, 3), Lambda (N, 3, 3),
    matched (N,), d2 (N,); d2 = inf where nothing matched)."""
    _require_sparse_views(field, "_ndt_correspond")
    pos, ok = _neighbour_slots(pts, field, spec)
    mus = field.means[pos]                                   # (N, 27, 3)
    lams = field.info[pos]                                   # (N, 27, 3, 3)
    d = pts[:, None, :] - mus
    d2 = torch.einsum("nki,nkij,nkj->nk", d, lams, d)
    d2 = torch.where(ok, d2, math.inf)
    best = torch.argmin(d2, dim=1)
    rows = torch.arange(pts.shape[0], device=pts.device)
    best_d2 = d2[rows, best]
    return (mus[rows, best], lams[rows, best], torch.isfinite(best_d2),
            best_d2)


def _ndt_point_terms(src: PointCloud, T: torch.Tensor, field: NDTField,
                     spec: VoxelGridSpec, params: NDTParams,
                     gamma: Optional[float] = None, isotropic: bool = False):
    """Smooth NDT objective and its Gauss-Newton terms at pose T over the
    sparse views, summed over every valid Gaussian of each point's
    27-neighbourhood: cost = -sum s, s = exp(-0.5 min(d2 / gamma, 30))
    gated by |Tp - mu| < max_corr_dist; H = sum s J^T Lambda J,
    b = sum s J^T Lambda r. ``isotropic`` scores the Euclidean distance
    with Lambda = I / sigma^2, sigma = max_corr_dist / 2 (the point-to-mean
    stage). Returns (H, b, cost, (N,) bool: the point matched a
    Gaussian)."""
    _require_sparse_views(field, "_ndt_terms")
    pts = se3.apply(T, src.points)
    n = pts.shape[0]
    pos, ok = _neighbour_slots(pts, field, spec)
    mus = field.means[pos]
    lams = field.info[pos]
    r = pts[:, None, :] - mus
    d2 = torch.einsum("nki,nkij,nkj->nk", r, lams, r)
    de2 = torch.sum(r * r, dim=-1)
    gate = ok & src.mask[:, None] & (de2 < params.max_corr_dist ** 2)
    g = _f32(params.score_temperature) if gamma is None else gamma
    if isotropic:
        sig2 = _f32((0.5 * params.max_corr_dist) ** 2)
        eye3 = torch.eye(3, dtype=pts.dtype, device=pts.device) / sig2
        lams = eye3.expand(lams.shape)
        s = torch.where(gate, torch.exp(-0.5 * de2 / _f32(sig2 * g)), 0.0)
    else:
        s = torch.where(gate, torch.exp(-0.5 * torch.clamp(d2 / g,
                                                           max=30.0)), 0.0)
    L = torch.einsum("nk,nkij->nij", s, lams)                # (N, 3, 3)
    y = torch.einsum("nk,nkij,nkj->ni", s, lams, r)          # (N, 3)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(n, 3, 3)
    J = torch.cat([eye, -se3.hat(pts)], dim=2)               # (N, 3, 6)
    H = torch.einsum("nia,nij,njb->ab", J, L, J)
    b = torch.einsum("nia,ni->a", J, y)
    return H, b, -torch.sum(s), gate.any(dim=1)


def _ndt_terms(src: PointCloud, T: torch.Tensor, field: NDTField,
               spec: VoxelGridSpec, params: NDTParams,
               gamma: Optional[float] = None, isotropic: bool = False):
    """``_ndt_point_terms`` with the matched points as a fraction of the
    valid ones: (H, b, cost, matched fraction)."""
    H, b, cost, matched = _ndt_point_terms(src, T, field, spec, params,
                                           gamma, isotropic)
    dt = H.dtype
    frac = matched.sum(dtype=dt) / torch.clamp(src.mask.sum(dtype=dt),
                                               min=1.0)
    return H, b, cost, frac


def ndt_register(source: PointCloud, field: NDTField, spec: VoxelGridSpec,
                 init_T: Optional[torch.Tensor] = None,
                 params: NDTParams = NDTParams(),
                 far_field: Optional[NDTField] = None,
                 far_spec: Optional[VoxelGridSpec] = None,
                 sync_free: bool = False) -> NDTResult:
    """Register a source cloud against an NDT field (scan-to-map).

    Levenberg-Marquardt with accept/reject on the NDT objective. A dense
    field takes the kernel path; there, with ``far_field``/``far_spec``,
    source points whose fine-window cell at the stage-entry pose is
    outside the window are binned into the far field's window and their
    terms added to the same H and b. A sparse field takes the sparse path
    (``far_field`` and ``yaw_candidates`` are kernel-path options and are
    not used there). ``sync_free`` runs ``lm_schedule``'s sync-free form
    (``iterations`` is then a device tensor). Inside a step's
    ``utils.tracing.stage_marks`` it marks its rasters ("raster") and the
    rest ("solve").
    """
    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster, ndt_terms

    use_kernel = field.rows is not None
    if use_kernel and params.isotropic_iterations > 0:
        raise ValueError("isotropic_iterations > 0 needs the sparse field "
                         "views (terms_impl='xla'); on the kernel path use "
                         "the coarse pyramid for large-init capture")
    if use_kernel and not params.use_neighborhood:
        raise ValueError("the dense kernel path needs use_neighborhood")
    if not use_kernel:
        _require_sparse_views(field, "ndt_register")
    tracing.mark("solve")
    dev = source.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    src = source.sanitize()
    n_src_pts = torch.clamp(src.mask.sum(dtype=f32), min=1.0)
    q = params.raster_q
    dims = field.window_dims
    use_far = use_kernel and far_field is not None
    if use_kernel:
        origin_w = (spec.origin_tensor(dev)
                    + field.origin_cell.to(f32) * spec.leaf)
    if use_far:
        far_origin_w = (far_spec.origin_tensor(dev)
                        + far_field.origin_cell.to(f32) * far_spec.leaf)
        far_corr = params.max_corr_dist * (far_spec.leaf / spec.leaf)

    def bin_raster(T0, with_far=True):
        tracing.mark("raster")
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
        tracing.mark("solve")
        fine, far = raster
        H, b, cost, cnt = ndt_terms(fine, field.rows, T, gamma,
                                    params.max_corr_dist, dims)
        if far is not None:
            Hf, bf, costf, cntf = ndt_terms(far, far_field.rows, T, gamma,
                                            far_corr, far_field.window_dims)
            H, b = H + Hf, b + bf
            cost, cnt = cost + costf, cnt + cntf
        return H, b, cost, cnt / n_src_pts

    def sparse_terms(T, gamma, isotropic):
        return _ndt_terms(src, T, field, spec, params, gamma, isotropic)

    def yaw_cost(Ty, gamma_y):
        fine, _ = bin_raster(Ty, with_far=False)
        tracing.mark("solve")
        return ndt_terms(fine, field.rows, Ty, gamma_y, params.max_corr_dist,
                         dims)[2]

    T, iters, frac, cost, dx = lm_schedule(
        init_T, params, use_kernel,
        kernel_terms if use_kernel else sparse_terms, bin_raster, yaw_cost,
        sync_free=sync_free)
    return NDTResult(T=T, iterations=iters, score=-cost / n_src_pts,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)


# the captured registrations, by their inputs' signature and static args
_registers: Dict[Tuple, CapturedCall] = {}


def compiled_register(source: PointCloud, field: NDTField,
                      spec: VoxelGridSpec,
                      init_T: Optional[torch.Tensor] = None,
                      params: NDTParams = NDTParams(),
                      far_field: Optional[NDTField] = None,
                      far_spec: Optional[VoxelGridSpec] = None,
                      compiled: bool = True) -> NDTResult:
    """``ndt_register`` as the reference's compiled program.

    With ``compiled``: on a CUDA device, one replay of the sync-free form
    captured as a CUDA graph at the first call for these inputs'
    signature (the source's capacity; the field's path, window dims and
    capacity; the far tier's; shapes, strides, dtypes, device) and the
    static ``spec``, ``far_spec`` and ``params``; the source (points and
    mask), the field and the pose are copied into the graph's own buffers
    at every call. On the CPU the sync-free form runs eagerly. Either way
    ``iterations`` is a () int32 tensor. ``compiled=False`` runs the
    host-exit form. All three give the same bits.
    """
    if not compiled:
        return ndt_register(source, field, spec, init_T=init_T,
                            params=params, far_field=far_field,
                            far_spec=far_spec)
    dev = source.points.device
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        return ndt_register(source, field, spec, init_T=init_T,
                            params=params, far_field=far_field,
                            far_spec=far_spec, sync_free=True)
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms

    def body(src, fld, T0, far):
        return ndt_register(src, fld, spec, init_T=T0, params=params,
                            far_field=far, far_spec=far_spec, sync_free=True)

    return replay(_registers, body,
                  (PointCloud(source.points, source.mask), field, init_T,
                   far_field),
                  static=(spec, far_spec, params), counters=(ndt_terms,))


def lm_trips(params: NDTParams) -> int:
    """The LM trips of ``lm_schedule``'s sync-free form on the kernel path
    (the coarse stage's and the staged fine solve's; each counts as an
    iteration only while its loop's condition holds)."""
    coarse = (params.coarse_iterations if params.coarse_iterations > 0
              and params.coarse_temperature_scale > 1.0 else 0)
    per = max(1, params.rebin_iters)
    return coarse + -(-params.max_iterations // per) * per


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
