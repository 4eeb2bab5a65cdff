"""Window-resident dense moment grid — the odometry-rate map structure.

Port of ``tpu_slam.mapping.dense_map``: ``rows`` (G, 10) float32 per-cell
moments [n, s(3), outer-triu(6)] taken about each cell's own corner, and
``origin_cell`` (3,) int32 placing window cell (0, 0, 0) on the global cell
lattice of a VoxelGridSpec. Insert is one sort-based accumulate
(``core.scatter.accumulate_rows``, no float atomics); the NDT field comes
straight from the window moments (three separable 3x3x3 passes +
closed-form floored inverses).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

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
    half = torch.tensor([wx // 2, wy // 2, wz // 2], dtype=torch.int32,
                        device=dev)
    hi = torch.tensor([n - wx, n - wy, n - wz], dtype=torch.int32, device=dev)
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
    wx, wy, wz = grid.dims
    pts = cloud.points
    dev = pts.device
    origin_w = (spec.origin_tensor(dev)
                + grid.origin_cell.to(torch.float32) * spec.leaf)
    hi = torch.tensor([wx, wy, wz], dtype=torch.float32, device=dev)
    # clip BEFORE the int conversion: padded points sit at 1e8
    rel = torch.minimum(torch.clamp((pts - origin_w) / spec.leaf, min=-1.0),
                        hi)
    cc = torch.floor(rel).to(torch.int32)
    ok = cloud.mask & ((cc >= 0) & (cc < hi.to(torch.int32))).all(dim=1)
    cell = (cc[:, 0] * wy + cc[:, 1]) * wz + cc[:, 2]
    # dropped points add zeros to a cell of their own row index, so no one
    # index gathers the whole padded tail (a long serial run in the sort-
    # based accumulate)
    spread = torch.remainder(torch.arange(pts.shape[0], device=dev),
                             grid.g)
    cell = torch.where(ok, cell.long(), spread)

    corner = origin_w + cc.to(torch.float32) * spec.leaf
    local = torch.where(ok[:, None], pts - corner, 0.0)
    w = ok.to(torch.float32) * torch.as_tensor(weight, dtype=torch.float32,
                                               device=dev)
    lw = local * w[:, None]
    contrib = torch.cat([
        w[:, None], lw,
        local[:, 0:1] * lw[:, 0:3],            # oxx oxy oxz
        local[:, 1:2] * lw[:, 1:3],            # oyy oyz
        local[:, 2:3] * lw[:, 2:3]], dim=1)    # ozz
    rows = accumulate_rows(grid.rows.clone(), cell, contrib)
    return DenseMomentGrid(rows=rows, origin_cell=grid.origin_cell,
                           dims=grid.dims)


def grid_scroll(grid: DenseMomentGrid, shift: torch.Tensor
                ) -> DenseMomentGrid:
    """Move the window by ``shift`` whole cells; vacated slabs are zeroed.

    The shift is read back to the host once (one synchronisation) so the
    roll runs with static sizes; a zero shift returns the grid unchanged.
    """
    s = [int(v) for v in shift.tolist()]
    if not any(s):
        return grid
    wx, wy, wz = grid.dims
    ch = grid.rows.shape[-1]
    a = torch.roll(grid.rows.reshape(wx, wy, wz, ch),
                   shifts=[-v for v in s], dims=[0, 1, 2]).clone()
    for ax, v in enumerate(s):
        n_ax = grid.dims[ax]
        if v > 0:
            a.narrow(ax, max(n_ax - v, 0), min(v, n_ax)).zero_()
        elif v < 0:
            a.narrow(ax, 0, min(-v, n_ax)).zero_()
    return DenseMomentGrid(rows=a.reshape(-1, ch),
                           origin_cell=grid.origin_cell + shift.to(torch.int32),
                           dims=grid.dims)


def grid_recenter_shift(grid: DenseMomentGrid, center_world: torch.Tensor,
                        spec: VoxelGridSpec, align: int = 4,
                        deadband_fraction: float = 0.25) -> torch.Tensor:
    """Shift (multiples of ``align``) that re-centers the window, 0 until
    the sensor strays ``deadband_fraction`` of the half-extent from it."""
    target = centered_origin_cell(center_world, spec, grid.dims, align)
    err = target - grid.origin_cell
    dev = err.device
    half = torch.tensor([d // 2 for d in grid.dims], dtype=torch.int32,
                        device=dev)
    limit = torch.clamp((half.to(torch.float32) * deadband_fraction)
                        .to(torch.int32), min=align)
    need = (err.abs() >= limit).any()
    return torch.where(need, err, torch.zeros_like(err)).to(torch.int32)


def grid_ndt_field(grid: DenseMomentGrid, spec: VoxelGridSpec,
                   min_voxel_count: float = 5.0,
                   evec_floor_ratio: float = 0.01):
    """NDT field rows straight from the window moments.

    Returns a registration.ndt.NDTField whose ``rows`` (G, 16) x-major are
    [mean world (3), information upper triangle (6), valid, pad (6)], zero
    where invalid — the rows the NDT terms kernel indexes directly.
    """
    from tpu_slam_torch.core.sym3 import floored_info_sym3_tri
    from tpu_slam_torch.registration.ndt import NDTField, _nbr_moment_pass

    wx, wy, wz = grid.dims
    g = wx * wy * wz
    dev = grid.rows.device
    occ = grid.rows[:, 0] > 0.0
    a = grid.rows.reshape(wx, wy, wz, 10)
    for axis in (2, 1, 0):
        a = _nbr_moment_pass(a, axis, spec.leaf)
    a = a.reshape(g, 10)

    cnt = a[:, 0]
    safe = torch.clamp(cnt, min=1e-6)
    mean_local = a[:, 1:4] / safe[:, None]
    mx, my, mz = mean_local[:, 0], mean_local[:, 1], mean_local[:, 2]
    inv = 1.0 / safe
    cov_tri = (a[:, 4] * inv - mx * mx, a[:, 5] * inv - mx * my,
               a[:, 6] * inv - mx * mz, a[:, 7] * inv - my * my,
               a[:, 8] * inv - my * mz, a[:, 9] * inv - mz * mz)
    info_tri = floored_info_sym3_tri(cov_tri, evec_floor_ratio)
    valid = occ & (cnt >= min_voxel_count)

    ci = torch.arange(g, dtype=torch.int32, device=dev)
    cell = torch.stack([ci // (wy * wz), (ci // wz) % wy, ci % wz], dim=1)
    cell = cell + grid.origin_cell[None, :]
    mean_world = (cell.to(torch.float32) * spec.leaf
                  + spec.origin_tensor(dev) + mean_local)

    rows16 = torch.cat(
        [mean_world] + [c[:, None] for c in info_tri]
        + [valid[:, None].to(torch.float32),
           torch.zeros((g, 6), dtype=torch.float32, device=dev)], dim=1)
    rows16 = torch.where(valid[:, None], rows16, 0.0).contiguous()
    return NDTField(rows=rows16, origin_cell=grid.origin_cell,
                    window_dims=grid.dims)
