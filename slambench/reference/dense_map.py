"""Window-resident dense moment grid — the odometry-rate map structure.

Frozen copy of ``tpu_slam_torch.mapping.dense_map``: ``rows`` (G, 10)
float32 per-cell moments [n, s(3), outer-triu(6)] taken about each cell's
own corner, and ``origin_cell`` (3,) int32 placing window cell (0, 0, 0) on
the global cell lattice of a VoxelGridSpec. Insert is one sort-based
accumulate (``core.scatter.accumulate_rows``, no float atomics); the NDT
field comes straight from the window moments (three separable 3x3x3 passes +
closed-form floored inverses). A log-odds layer of the same shape carries
free-space evidence (``grid_occupancy_update``) that clears the moments of
cells a moving object has left."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from slambench.reference.consts import const
from slambench.reference.pointcloud import PointCloud
from slambench.reference.scatter import accumulate_rows
from slambench.reference.voxel_hash import VoxelGridSpec


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


def field_rows(moments: torch.Tensor, occupied: torch.Tensor,
               origin_cell: torch.Tensor, dims: Tuple[int, int, int],
               spec: VoxelGridSpec, min_voxel_count: float,
               evec_floor_ratio: float, count_floor: float) -> torch.Tensor:
    """NDT field rows (G, 16) x-major from a window's (G, 10) corner-local
    moments: the 27-cell sums (three separable passes), mean and
    covariance over max(count, ``count_floor``), the closed-form floored
    inverse, and [mean world (3), information upper triangle (6), valid,
    pad (6)], zero where not ``occupied`` or below ``min_voxel_count``."""
    from slambench.reference.sym3 import floored_info_sym3_tri
    from slambench.reference.ndt import _nbr_moment_pass

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
    from slambench.reference.ndt import NDTField

    rows16 = field_rows(grid.rows, grid.rows[:, 0] > 0.0, grid.origin_cell,
                        grid.dims, spec, min_voxel_count, evec_floor_ratio,
                        count_floor=1e-6)
    return NDTField(rows=rows16, origin_cell=grid.origin_cell,
                    window_dims=grid.dims)


