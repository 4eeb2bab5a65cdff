"""Occupancy (hit/miss log-odds) layered on the sparse voxel map.

Port of ``tpu_slam.mapping.occupancy``. Free-space evidence is sampled
along each ray at leaf/2 steps (one (N, n_steps) lattice of samples, no
per-ray loop); the samples' and endpoints' keys are sorted once and each
voxel takes one increment a scan: the hit odds when an endpoint lies in
it, else the miss odds. The grid is sorted keys with log-odds, merged by
the same sort-merge discipline as the voxel map, and a map voxel whose
log-odds fall below a threshold is evicted from the moments map
(dynamic-object removal).

The per-voxel reduction is a maximum and a minimum of constants, and an
update adds at most two values per key, so keys, log-odds and evictions
do not depend on the order of any sum.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               cell_coords, pack_key,
                                               segment_ids_from_sorted_keys)
from tpu_slam_torch.mapping.voxel_map import (_first_keys, _segment_max,
                                              _segment_sums, _stable_order,
                                              evict_where)


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Sorted occupancy voxels: key and log-odds (INVALID_KEY tail)."""

    keys: torch.Tensor       # (C,) int32 sorted
    log_odds: torch.Tensor   # (C,) float32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def occupied_mask(self, threshold: float = 0.0) -> torch.Tensor:
        return (self.keys != INVALID_KEY) & (self.log_odds > threshold)


def empty_occupancy(capacity: int, device=None) -> OccupancyGrid:
    from tpu_slam_torch import default_device

    dev = default_device(device)
    return OccupancyGrid(
        keys=torch.full((capacity,), INVALID_KEY, dtype=torch.int32,
                        device=dev),
        log_odds=torch.zeros(capacity, dtype=torch.float32, device=dev))


def ray_evidence(origin: torch.Tensor, cloud: PointCloud,
                 spec: VoxelGridSpec, n_steps: int = 128,
                 max_range: float = 30.0, hit_odds: float = 0.85,
                 miss_odds: float = -0.4):
    """Per-voxel log-odds increments of one scan's rays.

    origin (3,) sensor position and cloud (padded endpoints) in the map
    frame. Returns (keys (M,), delta (M,)), one row per touched voxel in
    key order, INVALID_KEY tail; M = N * n_steps + N.
    """
    pts = cloud.points
    n = pts.shape[0]
    dev = pts.device
    d = pts - origin
    rng = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                     + d[:, 2] * d[:, 2])
    rng_c = torch.clamp(rng, max=max_range)
    valid = cloud.mask & (rng > 1e-6)

    # free-space samples strictly inside the ray, stopping one leaf short
    # of the endpoint's voxel
    step = spec.leaf * 0.5
    t = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) * step
    frac_end = torch.clamp(rng_c - spec.leaf, min=0.0)
    sample_ok = valid[:, None] & (t[None, :] < frac_end[:, None])
    dirs = d / torch.clamp(rng, min=1e-9)[:, None]
    samples = origin + dirs[:, None, :] * t[None, :, None]     # (N, S, 3)
    skeys = pack_key(cell_coords(samples.reshape(-1, 3), spec), spec)
    skeys = torch.where(sample_ok.reshape(-1), skeys, INVALID_KEY)
    hkeys = pack_key(cell_coords(pts, spec), spec)
    hkeys = torch.where(valid & (rng <= max_range), hkeys, INVALID_KEY)

    all_keys = torch.cat([skeys, hkeys]).to(torch.int32)
    all_delta = torch.cat([
        torch.full((n * n_steps,), miss_odds, dtype=torch.float32,
                   device=dev),
        torch.full((n,), hit_odds, dtype=torch.float32, device=dev)])
    all_delta = torch.where(all_keys == INVALID_KEY, 0.0, all_delta)

    # per voxel, a hit overrides misses; one increment a scan
    order = torch.argsort(all_keys, stable=True)
    k = all_keys[order]
    dl = all_delta[order]
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    seg = seg_ids.long()
    valid_k = k != INVALID_KEY
    seg_max = _segment_max(dl, seg, m, -math.inf, valid_k)
    seg_min = -_segment_max(-dl, seg, m, -math.inf, valid_k)
    seg_delta = torch.where(seg_max > 0, seg_max, seg_min)
    seg_valid = _segment_max(valid_k.to(torch.int32), seg, m, 0,
                             valid_k) > 0
    out_keys = torch.where(seg_valid,
                           _first_keys(k, seg, is_start, valid_k, m),
                           INVALID_KEY).to(torch.int32)
    out_delta = torch.where(seg_valid, seg_delta, 0.0)
    order2 = _stable_order(~seg_valid)
    return out_keys[order2], out_delta[order2]


def occupancy_update(grid: OccupancyGrid, keys: torch.Tensor,
                     delta: torch.Tensor, min_log: float = -4.0,
                     max_log: float = 6.0) -> OccupancyGrid:
    """Merge log-odds evidence (sort, segment sum, clamp), keeping the
    ``capacity`` voxels of strongest evidence (|log-odds|, ties in key
    order), in key order."""
    C = grid.capacity
    all_keys = torch.cat([grid.keys, keys])
    order = torch.argsort(all_keys, stable=True)
    k = all_keys[order]
    lo = torch.cat([grid.log_odds, delta])[order]
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    seg = seg_ids.long()
    valid = k != INVALID_KEY
    (mlo,) = _segment_sums(seg, m, valid, lo)
    seg_valid = _segment_max(valid.to(torch.int32), seg, m, 0, valid) > 0
    mk = torch.where(seg_valid, _first_keys(k, seg, is_start, valid, m),
                     INVALID_KEY).to(torch.int32)
    mlo = torch.clamp(mlo, min_log, max_log)
    rank = torch.where(seg_valid, -torch.abs(mlo), math.inf)
    keep = torch.argsort(rank, stable=True)[:C]
    kk = mk[keep]
    final = torch.argsort(kk, stable=True)
    return OccupancyGrid(keys=kk[final], log_odds=mlo[keep[final]])


def shift_occupancy_cells(grid: OccupancyGrid, spec: VoxelGridSpec,
                          shift: torch.Tensor) -> OccupancyGrid:
    """Scrolling-window rebase (see ``voxel_map.shift_map_cells``)."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    keys = grid.keys
    shift = torch.as_tensor(shift, dtype=torch.int32, device=keys.device)
    cx = ((keys >> (2 * b)) & (n - 1)) - shift[0]
    cy = ((keys >> b) & (n - 1)) - shift[1]
    cz = (keys & (n - 1)) - shift[2]
    inb = ((keys != INVALID_KEY) & (cx >= 0) & (cx < n) & (cy >= 0)
           & (cy < n) & (cz >= 0) & (cz < n))
    new_keys = torch.where(inb, (cx << (2 * b)) | (cy << b) | cz,
                           INVALID_KEY).to(torch.int32)
    order = torch.argsort(new_keys, stable=True)
    return OccupancyGrid(keys=new_keys[order],
                         log_odds=torch.where(inb, grid.log_odds,
                                              0.0)[order])


def query_log_odds_keys(grid: OccupancyGrid,
                        keys: torch.Tensor) -> torch.Tensor:
    """(N,) log-odds of voxel keys; 0 (unknown) where absent."""
    pos = torch.clamp(torch.searchsorted(grid.keys, keys), 0,
                      grid.capacity - 1)
    hit = (grid.keys[pos] == keys) & (keys != INVALID_KEY)
    return torch.where(hit, grid.log_odds[pos], 0.0)


def occupancy_maintain(grid: OccupancyGrid, vmap, origin: torch.Tensor,
                       cloud: PointCloud, spec: VoxelGridSpec,
                       n_steps: int = 64, max_range: float = 30.0,
                       evict_below: float = -1.0):
    """One scan of free-space maintenance: update the log-odds, then evict
    the map voxels whose log-odds fell below ``evict_below`` (the grid
    shares the map's spec, so keys compare directly). Returns
    (grid, vmap, n_evicted (int32 tensor))."""
    keys, delta = ray_evidence(origin, cloud, spec, n_steps=n_steps,
                               max_range=max_range)
    grid = occupancy_update(grid, keys, delta)
    lo = query_log_odds_keys(grid, vmap.keys)
    drop = (vmap.keys != INVALID_KEY) & (lo < evict_below)
    return grid, evict_where(vmap, drop), drop.sum(dtype=torch.int32)


def occupancy_probability(grid: OccupancyGrid) -> torch.Tensor:
    """(C,) occupancy probability from log-odds."""
    return torch.sigmoid(grid.log_odds)


def query_occupancy(grid: OccupancyGrid, points: torch.Tensor,
                    spec: VoxelGridSpec) -> torch.Tensor:
    """(N,) log-odds at query points; 0 (unknown) where no voxel exists."""
    return query_log_odds_keys(grid, pack_key(cell_coords(points, spec),
                                              spec))
