"""Plain re-computation of the host engine's sparse voxel map.

The map of ``tpu_slam_torch.mapping.voxel_map`` as a set of occupied
cells: each cell's point count, sum and sum of outer products of its
points taken about the cell's own corner. A cloud is inserted by summing
its points cell by cell (in point order) and adding those sums to the
map's; the NDT field is the dense window of the map's cells round a
centre (``registration.ndt._ndt_field_dense``'s window: 2^window_bits
cells a side, not aligned, clipped into the grid) turned into field rows
by the dense map's ``field_rows``; the rebuild after a loop inserts every
live keyframe's cloud at its optimized pose into an empty map.

Departures from the port: the cells are kept by ``torch.unique`` and one
sort-based scatter-add a merge (the port's incremental merge adds the
scan's sums into a fixed-capacity sorted list, and its full merge
re-sorts); no capacity and no eviction (the port keeps the newest
``map_capacity`` voxels: a map that would need more raises here); no
stamps, which only that eviction reads. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slambench.reference.dense_map import field_rows
from slambench.reference.ndt import NDTField, NDTParams
from slambench.reference.pointcloud import PointCloud
from slambench.reference.scatter import accumulate_rows
from slambench.reference.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                            voxel_keys)


def _corner(keys: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    b, m = spec.dim_bits, spec.cells_per_axis - 1
    cc = torch.stack([(keys >> (2 * b)) & m, (keys >> b) & m, keys & m],
                     dim=-1)
    return cc.to(torch.float32) * spec.leaf + spec.origin_tensor(keys.device)


def _cell_sums(keys: torch.Tensor, rows: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique keys ascending, the rows of each key summed in order)."""
    uk, inv = torch.unique(keys, sorted=True, return_inverse=True)
    out = rows.new_zeros((uk.shape[0], rows.shape[1]))
    return uk, accumulate_rows(out, inv, rows)


class SparseVoxelMap:
    """Occupied cells of ``spec`` with their corner-local moments:
    ``keys`` (M,) int32 ascending, ``moments`` (M, 13) float32 [count,
    sum (3), outer (9) row-major]; at most ``capacity`` cells."""

    def __init__(self, spec: VoxelGridSpec, capacity: int, device):
        self.spec, self.capacity = spec, capacity
        self.device = torch.device(device)
        self.keys = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.moments = torch.zeros((0, 13), dtype=torch.float32,
                                   device=self.device)

    def insert(self, cloud: PointCloud) -> None:
        """Add a world-frame cloud's valid points inside the grid."""
        keys = voxel_keys(cloud, self.spec)
        ok = keys != INVALID_KEY
        k, p = keys[ok], cloud.points[ok]
        local = p - _corner(k, self.spec)
        rows = torch.cat([torch.ones_like(local[:, :1]), local,
                          (local[:, :, None] * local[:, None, :]
                           ).reshape(-1, 9)], dim=1)
        sk, sm = _cell_sums(k, rows)
        self.keys, self.moments = _cell_sums(
            torch.cat([self.keys, sk]), torch.cat([self.moments, sm]))
        if self.keys.shape[0] > self.capacity:
            raise RuntimeError(f"{self.keys.shape[0]} occupied voxels > "
                               f"map_capacity {self.capacity}: the port "
                               "would evict, which this map does not")
        self.keys = self.keys.to(torch.int32)

    @property
    def n_occupied(self) -> int:
        return int(self.keys.shape[0])

    def total_count(self) -> float:
        return float(self.moments[:, 0].double().sum())

    def field(self, center: torch.Tensor, params: NDTParams) -> NDTField:
        """The dense NDT field window round ``center`` (world, (3,))."""
        spec, dev = self.spec, self.device
        n = spec.cells_per_axis
        w = min(n, 1 << min(spec.dim_bits, params.window_bits))
        dims = (w, w, w)
        cc = torch.floor((center.to(torch.float32)
                          - spec.origin_tensor(dev)) / spec.leaf
                         ).to(torch.int64)
        c0 = torch.clamp(cc - w // 2, 0, n - w)
        b, m = spec.dim_bits, n - 1
        k = self.keys.to(torch.int64)
        cell = torch.stack([(k >> (2 * b)) & m, (k >> b) & m, k & m], 1) - c0
        inside = ((cell >= 0) & (cell < w)).all(dim=1)
        idx = ((cell[:, 0] * w + cell[:, 1]) * w + cell[:, 2])[inside]
        mo = self.moments[inside]
        o = mo[:, 4:].reshape(-1, 3, 3)
        chan = torch.cat([mo[:, :4], o[:, 0, 0:1], o[:, 0, 1:2],
                          o[:, 0, 2:3], o[:, 1, 1:2], o[:, 1, 2:3],
                          o[:, 2, 2:3]], dim=1)
        g = w * w * w
        dense = torch.zeros((g, 10), dtype=torch.float32, device=dev)
        dense[idx] = chan
        occupied = torch.zeros(g, dtype=torch.bool, device=dev)
        occupied[idx] = True
        rows = field_rows(dense, occupied, c0.to(torch.int32), dims, spec,
                          params.min_voxel_count, params.evec_floor_ratio,
                          count_floor=1.0)
        return NDTField(rows=rows, origin_cell=c0.to(torch.int32),
                        window_dims=dims)


def rebuilt(spec: VoxelGridSpec, capacity: int, poses: torch.Tensor,
            clouds, device) -> SparseVoxelMap:
    """A map of the keyframe clouds ((P, 3) points, (P,) mask each, body
    frame) at ``poses`` (one (4, 4) each), from empty."""
    out = SparseVoxelMap(spec, capacity, device)
    pts = torch.cat([PointCloud(points=p, mask=m).transform(T).points
                     for (p, m), T in zip(clouds, poses)])
    msk = torch.cat([m for _, m in clouds])
    out.insert(PointCloud(points=pts, mask=msk))
    return out




def same_map(ref: SparseVoxelMap, keys: torch.Tensor,
             moments: torch.Tensor) -> bool:
    """Whether another map (``keys`` (C,) int32 ascending, ``INVALID_KEY``
    where empty, and ``moments`` (C, 13) in ``SparseVoxelMap``'s layout)
    holds ``ref``'s voxels with the same moments, bit for bit."""
    occ = keys != INVALID_KEY
    return (torch.equal(keys[occ], ref.keys)
            and torch.equal(moments[occ], ref.moments))
