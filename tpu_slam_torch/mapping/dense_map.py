"""Window-resident dense moment grid — the odometry-rate map structure.

Port of ``tpu_slam.mapping.dense_map``: ``rows`` (G, 10) float32 per-cell
moments [n, s(3), outer-triu(6)] taken about each cell's own corner, and
``origin_cell`` (3,) int32 placing window cell (0, 0, 0) on the global cell
lattice of a VoxelGridSpec. Insert is one sort-based accumulate
(``core.scatter.accumulate_rows``, no float atomics); the NDT field comes
straight from the window moments (three separable 3x3x3 passes +
closed-form floored inverses). A log-odds layer of the same shape carries
free-space evidence (``grid_occupancy_update``) that clears the moments
of cells a moving object has left.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from tpu_slam_torch.core.consts import const
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec


@dataclasses.dataclass(frozen=True)
class DenseMomentGrid:
    """Dense per-cell moment window on a global voxel lattice."""

    rows: torch.Tensor          # (G, 10) f32, cell-corner local moments
    origin_cell: torch.Tensor   # (3,) int32 window corner on the global grid
    dims: Tuple[int, int, int] = (64, 64, 32)

    @property
    def g(self) -> int:
        wx, wy, wz = self.dims
        return wx * wy * wz


def empty_grid(dims: Tuple[int, int, int], origin_cell,
               device=None) -> DenseMomentGrid:
    wx, wy, wz = dims
    oc = torch.as_tensor(origin_cell, dtype=torch.int32, device=device)
    return DenseMomentGrid(
        rows=torch.zeros((wx * wy * wz, 10), dtype=torch.float32,
                         device=oc.device),
        origin_cell=oc.clone(), dims=tuple(dims))


def weight_tensor(weight: Union[torch.Tensor, float], device
                  ) -> torch.Tensor:
    """An insert's ``weight`` as a float32 scalar on ``device``: a tensor
    as it is, a number by a fill (no copy from host memory)."""
    if isinstance(weight, torch.Tensor):
        return weight.to(device=device, dtype=torch.float32)
    return torch.full((), float(weight), dtype=torch.float32, device=device)


def _floor_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def centered_origin_cell(center_world: torch.Tensor, spec: VoxelGridSpec,
                         dims: Tuple[int, int, int],
                         align: int = 4) -> torch.Tensor:
    """Window corner cell centering ``center_world``, aligned to ``align``.

    Rounds to the nearest aligned corner and clips into the grid like
    ``jnp.clip``: when the window is wider than the grid the upper bound is
    below 0 and wins (a 192-cell window on a 128-cell grid sits at -64).
    """
    wx, wy, wz = dims
    n = spec.cells_per_axis
    dev = center_world.device
    origin = spec.origin_tensor(dev)
    cc = torch.floor((center_world.to(torch.float32) - origin)
                     / spec.leaf).to(torch.int32)
    half = const((wx // 2, wy // 2, wz // 2), torch.int32, dev)
    hi = const((n - wx, n - wy, n - wz), torch.int32, dev)
    c0 = _floor_div(cc - half + align // 2, align) * align
    upper = _floor_div(hi, align) * align
    return torch.minimum(torch.clamp(c0, min=0), upper).to(torch.int32)


def grid_insert(grid: DenseMomentGrid, cloud: PointCloud,
                spec: VoxelGridSpec,
                weight: Union[torch.Tensor, float] = 1.0) -> DenseMomentGrid:
    """Integrate a WORLD-frame cloud into the window (out of place).

    ``weight`` scales every point's contribution (0 = no-op insert, the
    branch-free reject path). Points outside the window are dropped.
    Accumulation is ``core.scatter.accumulate_rows``: a stable sort of the
    cell indices, then each cell's points summed in input order.
    """
    rows = insert_rows(grid.rows.clone(), grid.origin_cell, grid.dims, cloud,
                       spec, weight)
    return DenseMomentGrid(rows=rows, origin_cell=grid.origin_cell,
                           dims=grid.dims)


def insert_rows(rows: torch.Tensor, origin_cell: torch.Tensor,
                dims: Tuple[int, int, int], cloud: PointCloud,
                spec: VoxelGridSpec,
                weight: Union[torch.Tensor, float] = 1.0,
                x_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``grid_insert``'s accumulate into ``rows``, in place.

    ``origin_cell`` and ``dims`` are the whole window's. With ``x_range``
    = (x0, x1), ``rows`` holds only the window's x-planes x0 .. x1-1 (an
    x-chunk), and only points binned there are added; each point's cell and
    corner-local moments are computed in the whole window's frame, so a
    chunk's rows are bit-identical to those planes of the whole window's.
    """
    wx, wy, wz = dims
    x0, x1 = (0, wx) if x_range is None else x_range
    pts = cloud.points
    dev = pts.device
    origin_w = (spec.origin_tensor(dev)
                + origin_cell.to(torch.float32) * spec.leaf)
    hi = const((wx, wy, wz), torch.float32, dev)
    # clip BEFORE the int conversion: padded points sit at 1e8
    rel = torch.minimum(torch.clamp((pts - origin_w) / spec.leaf, min=-1.0),
                        hi)
    cc = torch.floor(rel).to(torch.int32)
    ok = (cloud.mask & ((cc >= 0) & (cc < hi.to(torch.int32))).all(dim=1)
          & (cc[:, 0] >= x0) & (cc[:, 0] < x1))
    cell = ((cc[:, 0] - x0) * wy + cc[:, 1]) * wz + cc[:, 2]
    # dropped points add zeros to a cell of their own row index, so no one
    # index gathers the whole padded tail (a long serial run in the sort-
    # based accumulate)
    spread = torch.remainder(torch.arange(pts.shape[0], device=dev),
                             rows.shape[0])
    cell = torch.where(ok, cell.long(), spread)

    corner = origin_w + cc.to(torch.float32) * spec.leaf
    local = torch.where(ok[:, None], pts - corner, 0.0)
    w = ok.to(torch.float32) * weight_tensor(weight, dev)
    lw = local * w[:, None]
    contrib = torch.cat([
        w[:, None], lw,
        local[:, 0:1] * lw[:, 0:3],            # oxx oxy oxz
        local[:, 1:2] * lw[:, 1:3],            # oyy oyz
        local[:, 2:3] * lw[:, 2:3]], dim=1)    # ozz
    return accumulate_rows(rows, cell, contrib)


def grid_scroll(grid: DenseMomentGrid, shift: torch.Tensor
                ) -> DenseMomentGrid:
    """Move the window by ``shift`` whole cells (a (3,) device tensor,
    never read back); vacated slabs are zeroed, and a zero shift gives
    the same bits.

    As the reference's: each axis wraps by its shift (out[i] = in[(i + s)
    mod n]), then the slabs the shift vacated are zeroed; a shift of n or
    more on an axis empties the window. The three wraps are one gather of
    whole rows.
    """
    dims = grid.dims
    dev = grid.rows.device
    s = shift.to(torch.int64)
    src, keep = None, None
    for ax, n in enumerate(dims):
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        idx = torch.remainder(pos + s[ax], n)
        ok = ((pos < n - torch.clamp(s[ax], min=0))
              & (pos >= torch.clamp(-s[ax], min=0)))
        src = idx if src is None else src[:, None] * n + idx
        keep = ok if keep is None else keep[:, None] & ok
        src, keep = src.reshape(-1), keep.reshape(-1)
    rows = torch.where(keep[:, None],
                       torch.index_select(grid.rows, 0, src), 0.0)
    return DenseMomentGrid(rows=rows,
                           origin_cell=grid.origin_cell + shift.to(torch.int32),
                           dims=dims)


def grid_recenter_shift(grid: DenseMomentGrid, center_world: torch.Tensor,
                        spec: VoxelGridSpec, align: int = 4,
                        deadband_fraction: float = 0.25) -> torch.Tensor:
    """Shift (multiples of ``align``) that re-centers the window, 0 until
    the sensor strays ``deadband_fraction`` of the half-extent from it."""
    target = centered_origin_cell(center_world, spec, grid.dims, align)
    err = target - grid.origin_cell
    dev = err.device
    half = const(tuple(d // 2 for d in grid.dims), torch.int32, dev)
    limit = torch.clamp((half.to(torch.float32) * deadband_fraction)
                        .to(torch.int32), min=align)
    need = (err.abs() >= limit).any()
    return torch.where(need, err, torch.zeros_like(err)).to(torch.int32)


def empty_occupancy_grid(dims: Tuple[int, int, int], origin_cell,
                         device=None) -> DenseMomentGrid:
    """A dense log-odds layer aligned with a moment window (rows (G, 1))."""
    wx, wy, wz = dims
    oc = torch.as_tensor(origin_cell, dtype=torch.int32, device=device)
    return DenseMomentGrid(
        rows=torch.zeros((wx * wy * wz, 1), dtype=torch.float32,
                         device=oc.device),
        origin_cell=oc.clone(), dims=tuple(dims))


def _window_cell(p: torch.Tensor, origin_w: torch.Tensor, leaf: float,
                 dims: Tuple[int, int, int]):
    """x-major window cell of world points and whether it is inside; the
    clip comes before the int conversion (padded points sit at 1e8)."""
    wx, wy, wz = dims
    hi = const((wx, wy, wz), torch.float32, p.device)
    rel = torch.minimum(torch.clamp((p - origin_w) / leaf, min=-1.0), hi)
    cc = torch.floor(rel).to(torch.int32)
    inside = ((cc >= 0) & (cc < hi.to(torch.int32))).all(dim=1)
    return (cc[:, 0] * wy + cc[:, 1]) * wz + cc[:, 2], inside


def grid_occupancy_update(grid: DenseMomentGrid, occ: DenseMomentGrid,
                          origin: torch.Tensor, cloud: PointCloud,
                          spec: VoxelGridSpec, n_steps: int = 64,
                          max_range: float = 30.0, hit_odds: float = 0.85,
                          miss_odds: float = -0.4,
                          evict_below: float = -1.0,
                          weight: Union[torch.Tensor, float] = 1.0):
    """Free-space evidence along each ray, then dynamic-object eviction.

    Free space is sampled along each ray at leaf/2 steps (one (N, n_steps)
    lattice, stopping one leaf short of the endpoint); a window cell that
    any sample reaches gets one miss, a cell holding an endpoint one hit
    (a hit wins), whatever the number of samples or points in it. Cells
    whose log-odds fall below ``evict_below`` while holding moments have
    their moment rows cleared and their evidence reset to neutral.

    The marks are equal-value writes (``index_fill_``), so the result does
    not depend on the order of the writes. ``weight`` 0 makes the whole
    update a no-op (the branch-free reject path). Returns
    (grid, occ, n_evicted), out of place.
    """
    wx, wy, wz = grid.dims
    g = wx * wy * wz
    pts = cloud.points
    dev = pts.device
    d = pts - origin
    rng = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                     + d[:, 2] * d[:, 2])
    rng_c = torch.clamp(rng, max=max_range)
    valid = cloud.mask & (rng > 1e-6)
    w = weight_tensor(weight, dev)
    origin_w = (spec.origin_tensor(dev)
                + occ.origin_cell.to(torch.float32) * spec.leaf)

    step = spec.leaf * 0.5
    t = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) * step
    frac_end = torch.clamp(rng_c - spec.leaf, min=0.0)
    sample_ok = valid[:, None] & (t[None, :] < frac_end[:, None])
    dirs = d / torch.clamp(rng, min=1e-9)[:, None]
    samples = (origin + dirs[:, None, :] * t[None, :, None]).reshape(-1, 3)
    scell, sin = _window_cell(samples, origin_w, spec.leaf, grid.dims)
    scell = torch.where(sample_ok.reshape(-1) & sin, scell, g)
    hcell, hin = _window_cell(pts, origin_w, spec.leaf, grid.dims)
    hcell = torch.where(valid & (rng <= max_range) & hin, hcell, g)

    def marks(idx):
        return torch.zeros(g + 1, dtype=torch.bool, device=dev).index_fill_(
            0, idx.long(), True)[:g]

    miss_mark, hit_mark = marks(scell), marks(hcell)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta = torch.where(hit_mark, torch.full_like(zero, hit_odds),
                        torch.where(miss_mark,
                                    torch.full_like(zero, miss_odds), zero))
    lo = torch.clamp(occ.rows[:, 0] + w * delta, -4.0, 4.0)

    evict = (grid.rows[:, 0] > 0) & (lo < evict_below) & (w > 0)
    n_evicted = evict.sum(dtype=torch.int32)
    rows = torch.where(evict[:, None], 0.0, grid.rows)
    # a cleared cell restarts from neutral, or it would re-evict every new
    # insert forever
    lo = torch.where(evict, zero, lo)
    return (DenseMomentGrid(rows=rows, origin_cell=grid.origin_cell,
                            dims=grid.dims),
            DenseMomentGrid(rows=lo[:, None], origin_cell=occ.origin_cell,
                            dims=occ.dims),
            n_evicted)


def grid_coarsen(grid: DenseMomentGrid, spec: VoxelGridSpec,
                 factor: int = 4) -> DenseMomentGrid:
    """Block-sum the fine moments into a ``factor`` x coarser window.

    Each fine cell's corner-local moments move to its coarse cell's corner
    (offset d, fixed per sub-cell) by the parallel-axis rule
    s' = s + n d, o'_ab = o_ab + d_a s_b + d_b s_a + n d_a d_b, then the
    factor^3 block is summed. Needs dims divisible by ``factor`` and an
    origin cell aligned to it (grid_recenter_shift keeps it so).
    """
    f = factor
    wx, wy, wz = grid.dims
    if wx % f or wy % f or wz % f:
        raise ValueError(f"dims {grid.dims} not divisible by factor {f}")
    dev = grid.rows.device
    a = grid.rows.reshape(wx // f, f, wy // f, f, wz // f, f, 10)
    off = torch.arange(f, dtype=torch.float32, device=dev) * spec.leaf
    dx = off.reshape(1, f, 1, 1, 1, 1)
    dy = off.reshape(1, 1, 1, f, 1, 1)
    dz = off.reshape(1, 1, 1, 1, 1, f)
    n = a[..., 0]
    sx, sy, sz = a[..., 1], a[..., 2], a[..., 3]
    oxx, oxy, oxz = a[..., 4], a[..., 5], a[..., 6]
    oyy, oyz, ozz = a[..., 7], a[..., 8], a[..., 9]
    out = torch.stack([
        n, sx + n * dx, sy + n * dy, sz + n * dz,
        oxx + 2.0 * dx * sx + n * dx * dx,
        oxy + dx * sy + dy * sx + n * dx * dy,
        oxz + dx * sz + dz * sx + n * dx * dz,
        oyy + 2.0 * dy * sy + n * dy * dy,
        oyz + dy * sz + dz * sy + n * dy * dz,
        ozz + 2.0 * dz * sz + n * dz * dz,
    ], dim=-1)
    coarse = out.sum(dim=(1, 3, 5))
    return DenseMomentGrid(rows=coarse.reshape(-1, 10),
                           origin_cell=_floor_div(grid.origin_cell, f),
                           dims=(wx // f, wy // f, wz // f))


def field_rows(moments: torch.Tensor, occupied: torch.Tensor,
               origin_cell: torch.Tensor, dims: Tuple[int, int, int],
               spec: VoxelGridSpec, min_voxel_count: float,
               evec_floor_ratio: float, count_floor: float) -> torch.Tensor:
    """NDT field rows (G, 16) x-major from a window's (G, 10) corner-local
    moments: the 27-cell sums (three separable passes), mean and
    covariance over max(count, ``count_floor``), the closed-form floored
    inverse, and [mean world (3), information upper triangle (6), valid,
    pad (6)], zero where not ``occupied`` or below ``min_voxel_count``."""
    from tpu_slam_torch.core.sym3 import floored_info_sym3_tri
    from tpu_slam_torch.registration.ndt import _nbr_moment_pass

    wx, wy, wz = dims
    g = wx * wy * wz
    dev = moments.device
    a = moments.reshape(wx, wy, wz, 10)
    for axis in (2, 1, 0):
        a = _nbr_moment_pass(a, axis, spec.leaf)
    a = a.reshape(g, 10)

    cnt = a[:, 0]
    safe = torch.clamp(cnt, min=count_floor)
    mean_local = a[:, 1:4] / safe[:, None]
    mx, my, mz = mean_local[:, 0], mean_local[:, 1], mean_local[:, 2]
    inv = 1.0 / safe
    cov_tri = (a[:, 4] * inv - mx * mx, a[:, 5] * inv - mx * my,
               a[:, 6] * inv - mx * mz, a[:, 7] * inv - my * my,
               a[:, 8] * inv - my * mz, a[:, 9] * inv - mz * mz)
    info_tri = floored_info_sym3_tri(cov_tri, evec_floor_ratio)
    valid = occupied & (cnt >= min_voxel_count)

    ci = torch.arange(g, dtype=torch.int32, device=dev)
    cell = torch.stack([ci // (wy * wz), (ci // wz) % wy, ci % wz], dim=1)
    cell = cell + origin_cell[None, :]
    mean_world = (cell.to(torch.float32) * spec.leaf
                  + spec.origin_tensor(dev) + mean_local)

    rows16 = torch.cat(
        [mean_world] + [c[:, None] for c in info_tri]
        + [valid[:, None].to(torch.float32),
           torch.zeros((g, 6), dtype=torch.float32, device=dev)], dim=1)
    return torch.where(valid[:, None], rows16, 0.0).contiguous()


def grid_ndt_field(grid: DenseMomentGrid, spec: VoxelGridSpec,
                   min_voxel_count: float = 5.0,
                   evec_floor_ratio: float = 0.01):
    """NDT field rows straight from the window moments.

    Returns a registration.ndt.NDTField whose ``rows`` (G, 16) x-major are
    [mean world (3), information upper triangle (6), valid, pad (6)], zero
    where invalid — the rows the NDT terms kernel indexes directly.
    """
    from tpu_slam_torch.registration.ndt import NDTField

    rows16 = field_rows(grid.rows, grid.rows[:, 0] > 0.0, grid.origin_cell,
                        grid.dims, spec, min_voxel_count, evec_floor_ratio,
                        count_floor=1e-6)
    return NDTField(rows=rows16, origin_cell=grid.origin_cell,
                    window_dims=grid.dims)


def grid_to_sparse_aggregates(grid: DenseMomentGrid, spec: VoxelGridSpec,
                              max_out: Optional[int] = None):
    """Window contents as sparse per-voxel aggregates under global keys.

    For spilling into a ``mapping.voxel_map.VoxelMap`` (checkpoint,
    loop-closure map, global export): (keys, count, sum_pts, sum_outer) in
    ``insert_scan_stats``'s convention, occupied cells first in key order
    (INVALID_KEY tail), cut to the first ``max_out`` rows (default: all G).
    """
    from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY

    wx, wy, wz = grid.dims
    g = wx * wy * wz
    b = spec.dim_bits
    ci = torch.arange(g, dtype=torch.int32, device=grid.rows.device)
    cell = torch.stack([ci // (wy * wz), (ci // wz) % wy, ci % wz], dim=1)
    cell = cell + grid.origin_cell[None, :]
    keys = (cell[:, 0] << (2 * b)) | (cell[:, 1] << b) | cell[:, 2]
    occ = grid.rows[:, 0] > 0.0
    keys = torch.where(occ, keys, INVALID_KEY).to(torch.int32)
    order = torch.argsort(keys, stable=True)
    if max_out is not None:
        order = order[:max_out]
    k = keys[order]
    r = grid.rows[order]
    tri = r[:, 4:10]
    outer = torch.stack([
        torch.stack([tri[:, 0], tri[:, 1], tri[:, 2]], -1),
        torch.stack([tri[:, 1], tri[:, 3], tri[:, 4]], -1),
        torch.stack([tri[:, 2], tri[:, 4], tri[:, 5]], -1)], -2)
    return k, r[:, 0], r[:, 1:4], outer
