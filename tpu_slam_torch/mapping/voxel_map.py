"""Sorted-voxel-list map with per-voxel Gaussian moments.

Port of the parts of ``tpu_slam.mapping.voxel_map`` that scan-to-map NDT
(bench config 3) uses: the fixed-capacity map sorted by packed cell key
(empty tail at INVALID_KEY), each voxel's count, sum and sum of outer
products taken about its own corner, the host bulk build
(``build_map_host``, numpy, float64 sums as the reference has them) and
the re-aggregation at a coarser leaf (``coarsen_map``). The per-scan
insert and the incremental merge of the reference are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               segment_ids_from_sorted_keys)

_INT32_MIN = -2 ** 31


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    """Fixed-capacity sorted voxel map; every tensor has ``capacity`` rows.
    ``sum_pts``/``sum_outer`` are moments about each voxel's corner
    (``decode_corner``)."""

    keys: torch.Tensor       # (C,) int32 ascending; INVALID_KEY = empty
    count: torch.Tensor      # (C,) float32 points integrated
    sum_pts: torch.Tensor    # (C, 3) float32 sum of voxel-local points
    sum_outer: torch.Tensor  # (C, 3, 3) float32 sum of outer products
    stamp: torch.Tensor      # (C,) float32 last update time

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def n_occupied(self) -> torch.Tensor:
        return (self.keys != INVALID_KEY).sum(dtype=torch.int32)

    def occupied_mask(self) -> torch.Tensor:
        return self.keys != INVALID_KEY


def empty_map(capacity: int, device=None) -> VoxelMap:
    from tpu_slam_torch import default_device

    dev = default_device(device)
    f32 = torch.float32
    return VoxelMap(
        keys=torch.full((capacity,), INVALID_KEY, dtype=torch.int32,
                        device=dev),
        count=torch.zeros(capacity, dtype=f32, device=dev),
        sum_pts=torch.zeros((capacity, 3), dtype=f32, device=dev),
        sum_outer=torch.zeros((capacity, 3, 3), dtype=f32, device=dev),
        stamp=torch.full((capacity,), -math.inf, dtype=f32, device=dev))


def voxel_map_from_numpy(keys, count, sum_pts, sum_outer, stamp,
                         device=None) -> VoxelMap:
    """A VoxelMap on ``device`` from host arrays (a map another engine
    built, e.g. ``np.asarray`` of the reference's fields)."""
    from tpu_slam_torch import default_device

    dev = default_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return VoxelMap(keys=t(keys, torch.int32), count=t(count, torch.float32),
                    sum_pts=t(sum_pts, torch.float32),
                    sum_outer=t(sum_outer, torch.float32),
                    stamp=t(stamp, torch.float32))


def decode_corner(keys: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """(...,) int32 keys -> (..., 3) float32 world corner of each cell."""
    b = spec.dim_bits
    m = spec.cells_per_axis - 1
    coords = torch.stack([(keys >> (2 * b)) & m, (keys >> b) & m, keys & m],
                         dim=-1).to(torch.float32)
    return coords * spec.leaf + spec.origin_tensor(keys.device)


def build_map_host(points, spec: VoxelGridSpec, capacity: int,
                   stamp: float = 0.0, device=None) -> VoxelMap:
    """Bulk map build from a host (M, 3) point array: one numpy sort and
    float64 ``reduceat`` sums, cast to float32 (the reference's arithmetic,
    so the arrays are bit-equal to its), then moved to ``device``."""
    pts = np.asarray(points, np.float32)
    n = spec.cells_per_axis
    b = spec.dim_bits
    origin = np.asarray(spec.origin, np.float32)
    cc = np.floor((pts - origin) / spec.leaf).astype(np.int64)
    ok = np.all((cc >= 0) & (cc < n), axis=1)
    pts, cc = pts[ok], cc[ok]
    key = (cc[:, 0] << (2 * b)) | (cc[:, 1] << b) | cc[:, 2]
    order = np.argsort(key, kind="stable")
    key, pts, cc = key[order], pts[order], cc[order]
    uk, start, cnt = np.unique(key, return_index=True, return_counts=True)
    if len(uk) > capacity:
        raise ValueError(f"{len(uk)} occupied voxels > capacity {capacity}")
    corners = cc.astype(np.float32) * spec.leaf + origin
    local = (pts - corners).astype(np.float64)
    outer = local[:, :, None] * local[:, None, :]
    ssum = np.add.reduceat(local, start, axis=0)
    souter = np.add.reduceat(outer.reshape(-1, 9), start, axis=0)

    keys = np.full(capacity, INVALID_KEY, np.int32)
    count = np.zeros(capacity, np.float32)
    sum_pts = np.zeros((capacity, 3), np.float32)
    sum_outer = np.zeros((capacity, 3, 3), np.float32)
    stamps = np.full(capacity, -np.inf, np.float32)
    m = len(uk)
    keys[:m] = uk.astype(np.int32)
    count[:m] = cnt
    sum_pts[:m] = ssum
    sum_outer[:m] = souter.reshape(-1, 3, 3)
    stamps[:m] = stamp
    return voxel_map_from_numpy(keys, count, sum_pts, sum_outer, stamps,
                                device=device)


def coarsen_map(vmap: VoxelMap, spec: VoxelGridSpec, factor: int = 4
                ) -> VoxelMap:
    """Re-aggregate the map's moments at a ``factor`` x coarser leaf (a
    power of two; the coarse spec is ``coarse_spec_of(spec, factor)``).

    Each voxel's moments move to its coarse cell's corner by the
    parallel-axis rule, the voxels are stable-sorted by coarse key, and
    each run of one key is summed in that order (``core.scatter``). The
    run's key is its first element's and its stamp the run's largest,
    both read from the sorted order.
    """
    s = int(math.log2(factor))
    if (1 << s) != factor:
        raise ValueError("factor must be a power of two")
    b = spec.dim_bits
    bc = b - s
    n = spec.cells_per_axis
    dev = vmap.keys.device
    f32 = torch.float32

    keys = vmap.keys
    occ = vmap.occupied_mask()
    cx = ((keys >> (2 * b)) & (n - 1)) >> s
    cy = ((keys >> b) & (n - 1)) >> s
    cz = (keys & (n - 1)) >> s
    ckeys = torch.where(occ, (cx << (2 * bc)) | (cy << bc) | cz,
                        INVALID_KEY).to(torch.int32)

    fine_corner = decode_corner(keys, spec)
    coarse_corner = (torch.stack([cx, cy, cz], dim=-1).to(f32)
                     * (spec.leaf * factor) + spec.origin_tensor(dev))
    d = torch.where(occ[:, None], fine_corner - coarse_corner, 0.0)
    nw = vmap.count
    sp = vmap.sum_pts
    s_shift = sp + nw[:, None] * d
    o_shift = (vmap.sum_outer + d[:, :, None] * sp[:, None, :]
               + sp[:, :, None] * d[:, None, :]
               + nw[:, None, None] * d[:, :, None] * d[:, None, :])

    order = torch.argsort(ckeys, stable=True)
    k = ckeys[order]
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    seg = seg_ids.long()
    valid = k != INVALID_KEY
    mc = accumulate_rows(torch.zeros(m, dtype=f32, device=dev), seg,
                         torch.where(valid, nw[order], 0.0))
    ms = accumulate_rows(torch.zeros((m, 3), dtype=f32, device=dev), seg,
                         torch.where(valid[:, None], s_shift[order], 0.0))
    mo = accumulate_rows(torch.zeros((m, 9), dtype=f32, device=dev), seg,
                         torch.where(valid[:, None],
                                     o_shift[order].reshape(m, 9), 0.0))
    # each run is contiguous in the sorted order: its largest stamp is a
    # segment max over the runs' lengths (empty segments get -inf)
    lengths = torch.bincount(seg, minlength=m)
    mst = torch.segment_reduce(
        torch.where(valid, vmap.stamp[order], -math.inf), "max",
        lengths=lengths, unsafe=True, initial=-math.inf)
    # first key of each run: one write a run, no two to one row
    first = is_start & valid
    mk = torch.full((m,), _INT32_MIN, dtype=torch.int32, device=dev)
    mk[seg[first]] = k[first]
    mk = torch.where(mc > 0, mk, INVALID_KEY).to(torch.int32)
    order2 = torch.argsort(mk, stable=True)
    return VoxelMap(keys=mk[order2], count=mc[order2], sum_pts=ms[order2],
                    sum_outer=mo[order2].reshape(m, 3, 3),
                    stamp=mst[order2])


def coarse_spec_of(spec: VoxelGridSpec, factor: int) -> VoxelGridSpec:
    """The lattice ``factor`` x coarser than ``spec``, same origin."""
    s = int(math.log2(factor))
    return VoxelGridSpec(leaf=spec.leaf * factor, origin=spec.origin,
                         dim_bits=spec.dim_bits - s)
