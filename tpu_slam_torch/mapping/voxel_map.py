"""Sorted-voxel-list map with per-voxel Gaussian moments.

Port of ``tpu_slam.mapping.voxel_map``: the fixed-capacity map sorted by
packed cell key (empty tail at INVALID_KEY), each voxel's count, sum and
sum of outer products taken about its own corner. A scan is aggregated per
voxel (``scan_to_voxel_stats``) and merged into the map either by the full
sort-merge (``insert_scan_stats``: concatenate, stable sort, segment sums,
keep the newest ``capacity`` voxels) or incrementally
(``insert_scan_stats_incremental``: dense adds on the voxels the scan hits,
new keys merged in by a gather, the full merge when they do not fit).
``insert_cloud`` is the reference's two compiled programs (the scan's
stats, then the merge whose overflow fallback is a ``lax.cond``): with
``compiled=True`` (the default) the stats, the merge and its overflow flag
are one sync-free program, a CUDA graph replay on a CUDA device (cached by
the inputs' signature and the static arguments) and eager on the CPU; the
flag is read after it, and in the rare overflow the full merge of the
untouched old map runs eagerly. ``compiled=False`` runs the same steps
eagerly. Both give the same bits. Scrolling-window rebase, eviction,
means, covariances, normals, the 27-neighbourhood moments, the host bulk
build (``build_map_host``, numpy, float64 sums as the reference has them)
and the re-aggregation at a coarser leaf (``coarsen_map``) complete the
module.

Every float segment sum goes through ``core.scatter`` (fixed order on both
devices); segment maxima are order-free. Sorts are stable, so ties fall as
the reference's ``argsort(stable=True)`` lets them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.core.scatter import accumulate_rows
from tpu_slam_torch.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               neighbor_offsets_keys,
                                               segment_ids_from_sorted_keys,
                                               voxel_keys)
from tpu_slam_torch.utils.capture import CapturedCall, compiled_call

_INT32_MIN = -2 ** 31
# the incremental merge's default bound on the new keys of one scan
NEW_CAP = 8192


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


def _spare_index(seg: torch.Tensor, m: int,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """``seg``, with each row where ``valid`` is False sent to a spare row
    of its own past ``m``: an INVALID_KEY tail is one long run of one
    segment, and a scatter that reduces a run in order would walk it row
    by row."""
    if valid is None:
        return seg
    spare = m + torch.arange(seg.shape[0], device=seg.device)
    return torch.where(valid, seg, spare)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, m: int,
                 fill, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment maximum of ``vals`` over ``m`` segments (``fill`` where a
    segment is empty), leaving out the rows where ``valid`` is False; a
    maximum does not depend on the order."""
    idx = _spare_index(seg, m, valid)
    out = torch.full((m + (0 if valid is None else seg.shape[0]),), fill,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amax")[:m]


def _segment_sums(seg: torch.Tensor, m: int, valid: torch.Tensor,
                  *vals: torch.Tensor):
    """Per-segment sums of each (M, ...) tensor over ``m`` segments, in row
    order, leaving out the rows where ``valid`` is False (one scatter for
    all of them)."""
    n = seg.shape[0]
    flats = [v.reshape(n, -1) for v in vals]
    widths = [f.shape[1] for f in flats]
    cat = torch.cat(flats, dim=1)
    acc = torch.zeros((m + n, cat.shape[1]), dtype=cat.dtype,
                      device=cat.device)
    acc = accumulate_rows(acc, _spare_index(seg, m, valid), cat)[:m]
    return [a.reshape((m,) + tuple(v.shape[1:]))
            for a, v in zip(acc.split(widths, dim=1), vals)]


def _first_keys(k: torch.Tensor, seg: torch.Tensor, is_start: torch.Tensor,
                valid: torch.Tensor, m: int) -> torch.Tensor:
    """Each segment's key from its first (valid) row: one write a segment,
    INT32_MIN where a segment has none. Every other row writes a spare
    slot of its own (no mask index, which would read its count back)."""
    mk = torch.full((m + seg.shape[0],), _INT32_MIN, dtype=torch.int32,
                    device=k.device)
    mk[_spare_index(seg, m, is_start & valid)] = k
    return mk[:m]


def _stamp_tensor(stamp, device) -> torch.Tensor:
    """``stamp`` (a number or a tensor) as a float32 scalar on ``device``;
    a number is filled there, with no copy from the host."""
    if isinstance(stamp, torch.Tensor):
        return stamp.to(device=device, dtype=torch.float32)
    return torch.full((), float(stamp), dtype=torch.float32, device=device)


def _stable_order(flag: torch.Tensor) -> torch.Tensor:
    """Stable argsort of a bool tensor (False first)."""
    return torch.argsort(flag.to(torch.uint8), stable=True)


def scan_to_voxel_stats(cloud: PointCloud, spec: VoxelGridSpec):
    """Aggregate a cloud into per-voxel moments about each voxel's corner.

    Returns (keys (N,), count (N,), sum_pts (N, 3), sum_outer (N, 3, 3)),
    one leading row per occupied voxel in key order, INVALID_KEY tail; N is
    the cloud's capacity.
    """
    n = cloud.capacity
    keys = voxel_keys(cloud, spec)
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    spts = cloud.points[order]
    valid = skeys != INVALID_KEY
    local = torch.where(valid[:, None], spts - decode_corner(skeys, spec),
                        0.0)
    outer = local[:, :, None] * local[:, None, :]
    seg_ids, is_start = segment_ids_from_sorted_keys(skeys)
    seg = seg_ids.long()
    w = valid.to(torch.float32)
    cnt, ssum, souter = _segment_sums(seg, n, valid, w, local,
                                      outer * w[:, None, None])
    seg_valid = cnt > 0
    out_keys = torch.where(seg_valid,
                           _first_keys(skeys, seg, is_start, valid, n),
                           INVALID_KEY).to(torch.int32)
    order2 = _stable_order(~seg_valid)
    return out_keys[order2], cnt[order2], ssum[order2], souter[order2]


def insert_scan_stats(vmap: VoxelMap, keys: torch.Tensor,
                      count: torch.Tensor, sum_pts: torch.Tensor,
                      sum_outer: torch.Tensor, stamp) -> VoxelMap:
    """Merge per-voxel aggregates into the map: concatenate, stable sort,
    segment-reduce equal keys, keep the ``capacity`` voxels with the newest
    stamps (ties in sorted-key order), and restore key order."""
    C = vmap.capacity
    stamp = _stamp_tensor(stamp, vmap.keys.device)
    new_stamp = torch.where(keys != INVALID_KEY, stamp, -math.inf)
    all_keys = torch.cat([vmap.keys, keys])
    order = torch.argsort(all_keys, stable=True)
    k = all_keys[order]
    c = torch.cat([vmap.count, count])[order]
    s = torch.cat([vmap.sum_pts, sum_pts])[order]
    o = torch.cat([vmap.sum_outer, sum_outer])[order]
    st = torch.cat([vmap.stamp, new_stamp])[order]

    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    seg = seg_ids.long()
    valid = k != INVALID_KEY
    mc, ms, mo = _segment_sums(seg, m, valid, c, s, o)
    mst = _segment_max(st, seg, m, -math.inf, valid)
    seg_valid = mc > 0
    mk = torch.where(seg_valid, _first_keys(k, seg, is_start, valid, m),
                     INVALID_KEY).to(torch.int32)

    # keep the C most recent voxels, then restore key order
    evict_rank = torch.where(seg_valid, -mst, math.inf)
    keep = torch.argsort(evict_rank, stable=True)[:C]
    kk = mk[keep]
    final = torch.argsort(kk, stable=True)
    sel = keep[final]
    return VoxelMap(keys=kk[final], count=mc[sel], sum_pts=ms[sel],
                    sum_outer=mo[sel], stamp=mst[sel])


def insert_scan_stats_incremental(vmap: VoxelMap, keys: torch.Tensor,
                                  count: torch.Tensor, sum_pts: torch.Tensor,
                                  sum_outer: torch.Tensor, stamp,
                                  new_cap: int = NEW_CAP):
    """Incremental merge: dense adds on the map voxels the scan hits, and
    the first ``new_cap`` new keys merged in by a gather (for output slot k,
    the new rows placed at or before k are counted by a binary search over
    their destinations; both sources are in key order, so nothing is
    re-sorted).

    When more than ``new_cap`` keys are new, or they would overflow the
    map, the full merge ``insert_scan_stats`` of the original map is the
    result instead: that choice is one host read of one flag. Returns
    ``(vmap, overflowed)``.
    """
    stamp = _stamp_tensor(stamp, vmap.keys.device)
    merged, overflow = _merge_incremental(vmap, keys, count, sum_pts,
                                          sum_outer, stamp, new_cap)
    if bool(overflow.item()):
        return insert_scan_stats(vmap, keys, count, sum_pts, sum_outer,
                                 stamp), True
    return merged, False


def _merge_incremental(vmap: VoxelMap, keys: torch.Tensor,
                       count: torch.Tensor, sum_pts: torch.Tensor,
                       sum_outer: torch.Tensor, stamp: torch.Tensor,
                       new_cap: int) -> Tuple[VoxelMap, torch.Tensor]:
    """The incremental merge and its overflow flag (a () bool tensor),
    read nowhere: where the flag is set, the merged map is not the result
    (every index stays in bounds all the same)."""
    C = vmap.capacity
    s_cap = keys.shape[0]
    dev = vmap.keys.device
    valid = keys != INVALID_KEY
    occ = vmap.occupied_mask()

    # -- hits: each map key searched among the scan's sorted keys --------
    pos = torch.clamp(torch.searchsorted(keys, vmap.keys), 0, s_cap - 1)
    hit = (keys[pos] == vmap.keys) & occ
    h = hit.to(torch.float32)
    new_count = vmap.count + h * count[pos]
    new_sum = vmap.sum_pts + h[:, None] * sum_pts[pos]
    new_outer = vmap.sum_outer + h[:, None, None] * sum_outer[pos]
    new_stamp = torch.where(hit, torch.maximum(vmap.stamp, stamp),
                            vmap.stamp)

    # -- new keys ---------------------------------------------------------
    mpos = torch.clamp(torch.searchsorted(vmap.keys, keys), 0, C - 1)
    is_new = valid & (vmap.keys[mpos] != keys)
    new_cap = min(new_cap, s_cap)
    n_new = is_new.sum(dtype=torch.int32)
    overflow = (n_new > new_cap) | (occ.sum(dtype=torch.int32) + n_new > C)

    # the first new_cap new rows, already in key order
    order = _stable_order(~is_new)[:new_cap]
    nk = torch.where(is_new[order], keys[order], INVALID_KEY).to(torch.int32)
    # destination of new row j: its insertion point among the old keys
    # plus its own rank; INVALID rows land past the end and are never read
    ins = torch.searchsorted(vmap.keys, nk).to(torch.int32)
    rank = torch.arange(new_cap, dtype=torch.int32, device=dev)
    dest = torch.where(nk != INVALID_KEY, ins + rank,
                       C + new_cap).to(torch.int32)
    k_out = torch.arange(C, dtype=torch.int32, device=dev)
    r = torch.searchsorted(dest, k_out).to(torch.int32)      # side left
    rc = torch.clamp(r, 0, new_cap - 1).long()
    take_new = dest[rc] == k_out
    msrc = torch.clamp(k_out - r, 0, C - 1).long()

    def pick(new_a, old_a):
        m = take_new.reshape((-1,) + (1,) * (new_a.ndim - 1))
        return torch.where(m, new_a[rc], old_a[msrc])

    return VoxelMap(
        keys=pick(nk, vmap.keys),
        count=pick(count[order], new_count),
        sum_pts=pick(sum_pts[order], new_sum),
        sum_outer=pick(sum_outer[order], new_outer),
        stamp=pick(torch.where(nk != INVALID_KEY, stamp, -math.inf),
                   new_stamp)), overflow


def _insert_program(vmap: VoxelMap, cloud: PointCloud, stamp: torch.Tensor,
                    spec: VoxelGridSpec, incremental: bool):
    """``insert_cloud``'s sync-free program: the full merge's map, or the
    incremental merge's map, its overflow flag and the scan's stats."""
    stats = scan_to_voxel_stats(cloud, spec)
    if not incremental:
        return insert_scan_stats(vmap, *stats, stamp)
    merged, overflow = _merge_incremental(vmap, *stats, stamp, NEW_CAP)
    return merged, overflow, stats


# the captured insert_cloud programs, by their inputs' signature and static
# args
_inserts: Dict[Tuple, CapturedCall] = {}


def insert_cloud(vmap: VoxelMap, cloud: PointCloud, spec: VoxelGridSpec,
                 stamp=0.0, incremental: bool = True,
                 compiled: bool = True) -> VoxelMap:
    """Integrate a (map-frame) cloud into the map. With ``incremental``,
    ``insert_cloud.fallbacks`` counts the inserts that took the full
    merge and ``insert_cloud.incremental`` those that did not.
    ``compiled``: see the module docstring."""
    if not compiled:
        keys, cnt, ssum, souter = scan_to_voxel_stats(cloud, spec)
        if not incremental:
            return insert_scan_stats(vmap, keys, cnt, ssum, souter, stamp)
        vmap, overflowed = insert_scan_stats_incremental(
            vmap, keys, cnt, ssum, souter, stamp)
        _count_insert(overflowed)
        return vmap
    program = functools.partial(_insert_program, spec=spec,
                                incremental=incremental)
    stamp = _stamp_tensor(stamp, vmap.keys.device)
    out = compiled_call(_inserts, program,
                        (vmap, PointCloud(cloud.points, cloud.mask), stamp),
                        static=(spec, incremental))
    return settle_insert(vmap, *out, stamp) if incremental else out


def settle_insert(vmap: Optional[VoxelMap], merged: VoxelMap,
                  overflow: torch.Tensor, stats, stamp) -> VoxelMap:
    """The result of an incremental insert program run on ``vmap`` (None:
    an empty map of ``merged``'s capacity): one read of its overflow
    flag, as the eager merge makes it, and on overflow the full merge of
    ``vmap`` (untouched) and the program's ``stats``, eagerly."""
    overflowed = bool(overflow.item())
    _count_insert(overflowed)
    if not overflowed:
        return merged
    if vmap is None:
        vmap = empty_map(merged.capacity, device=merged.keys.device)
    return insert_scan_stats(vmap, *stats, stamp)


def _count_insert(overflowed: bool) -> None:
    if overflowed:
        insert_cloud.fallbacks += 1
    else:
        insert_cloud.incremental += 1


insert_cloud.fallbacks = 0
insert_cloud.incremental = 0


def _rekey(vmap: VoxelMap, keys: torch.Tensor) -> VoxelMap:
    """The map with ``keys`` (INVALID_KEY = drop): dropped rows zeroed and
    stamped -inf, then one stable sort back to key order."""
    dead = keys == INVALID_KEY
    order = torch.argsort(keys, stable=True)

    def z(a):
        return torch.where(dead.reshape((-1,) + (1,) * (a.ndim - 1)), 0.0,
                           a)[order]

    return VoxelMap(keys=keys[order], count=z(vmap.count),
                    sum_pts=z(vmap.sum_pts), sum_outer=z(vmap.sum_outer),
                    stamp=torch.where(dead, -math.inf, vmap.stamp)[order])


def shift_map_cells(vmap: VoxelMap, spec: VoxelGridSpec,
                    shift: torch.Tensor) -> VoxelMap:
    """Scrolling-window rebase: cell c becomes c - shift ((3,) int32);
    voxels leaving the grid are dropped. Moments are corner-relative, so
    only the keys change."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    keys = vmap.keys
    shift = torch.as_tensor(shift, dtype=torch.int32, device=keys.device)
    cx = ((keys >> (2 * b)) & (n - 1)) - shift[0]
    cy = ((keys >> b) & (n - 1)) - shift[1]
    cz = (keys & (n - 1)) - shift[2]
    inb = ((keys != INVALID_KEY) & (cx >= 0) & (cx < n) & (cy >= 0)
           & (cy < n) & (cz >= 0) & (cz < n))
    return _rekey(vmap, torch.where(inb, (cx << (2 * b)) | (cy << b) | cz,
                                    INVALID_KEY).to(torch.int32))


def evict_where(vmap: VoxelMap, drop: torch.Tensor) -> VoxelMap:
    """Remove the voxels where ``drop`` is True (seen-through voxels)."""
    return _rekey(vmap, torch.where(drop, INVALID_KEY,
                                    vmap.keys).to(torch.int32))


def voxel_means(vmap: VoxelMap, spec: VoxelGridSpec) -> torch.Tensor:
    """(C, 3) world-frame voxel means; PAD_COORD where empty."""
    cnt = torch.clamp(vmap.count, min=1.0)
    mean = decode_corner(vmap.keys, spec) + vmap.sum_pts / cnt[:, None]
    return torch.where(vmap.occupied_mask()[:, None], mean, PAD_COORD)


def voxel_covariances(vmap: VoxelMap, min_count: float = 5.0,
                      regularization: float = 1e-3) -> torch.Tensor:
    """(C, 3, 3) covariance about the voxel mean plus ``regularization`` I;
    voxels under ``min_count`` points get 0.05 I."""
    cnt = torch.clamp(vmap.count, min=1.0)
    mean = vmap.sum_pts / cnt[:, None]
    cov = (vmap.sum_outer / cnt[:, None, None]
           - mean[:, :, None] * mean[:, None, :])
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    cov = cov + regularization * eye
    poor = vmap.count < min_count
    return torch.where(poor[:, None, None], eye * 0.05, cov)


# batched 3x3 eigh on the card refuses batches of 32,768 and more (the
# solver's workspace query fails); 16,384 a call works
EIGH_BATCH = 16384


def _smallest_normal(cov: torch.Tensor, planarity: float):
    """Eigenvector of the smallest eigenvalue and the planarity test
    (smallest < planarity x middle). ``torch.linalg.eigh`` as the
    reference's ``jnp.linalg.eigh``, in batches of EIGH_BATCH matrices:
    the sign (and, for a repeated eigenvalue, the direction within its
    space) is the solver's."""
    parts = [torch.linalg.eigh(c) for c in cov.split(EIGH_BATCH)]
    evals = torch.cat([p[0] for p in parts])
    evecs = torch.cat([p[1] for p in parts])
    planar = evals[:, 0] < planarity * torch.clamp(evals[:, 1], min=1e-12)
    return evecs[:, :, 0], planar


def voxel_normals(vmap: VoxelMap, min_count: float = 5.0):
    """(normals (C, 3), valid (C,)) from each voxel's own covariance."""
    normals, planar = _smallest_normal(
        voxel_covariances(vmap, min_count=min_count), 0.25)
    return normals, vmap.occupied_mask() & (vmap.count >= min_count) & planar


def lookup_voxels(vmap: VoxelMap, query_keys: torch.Tensor) -> torch.Tensor:
    """(N,) int32 slot of each query key in the sorted map, -1 if absent."""
    pos = torch.clamp(torch.searchsorted(vmap.keys, query_keys), 0,
                      vmap.capacity - 1)
    hit = (vmap.keys[pos] == query_keys) & (query_keys != INVALID_KEY)
    return torch.where(hit, pos, -1).to(torch.int32)


def neighborhood_moments(vmap: VoxelMap, spec: VoxelGridSpec,
                         lookup: Optional[torch.Tensor] = None):
    """27-neighbourhood moments of every voxel, each neighbour's moments
    moved to the centre voxel's corner (s' = s + n d,
    o' = o + d s^T + s d^T + n d d^T, d = corner_v - corner_0).

    The neighbours are found by binary search over the sorted keys, or
    with ``lookup`` (``build_dense_lookup``) by one gather. Returns
    (count (C,), mean_world (C, 3), cov (C, 3, 3)).
    """
    c = vmap.capacity
    nkeys = neighbor_offsets_keys(vmap.keys, spec)           # (C, 27)
    if lookup is not None:
        pos = lookup[torch.clamp(nkeys, 0, lookup.shape[0] - 1).long()]
        hit = (pos >= 0) & (nkeys != INVALID_KEY) & (nkeys >= 0)
        pos = torch.clamp(pos, min=0).long()
    else:
        pos = torch.clamp(torch.searchsorted(vmap.keys, nkeys), 0, c - 1)
        hit = (vmap.keys[pos] == nkeys) & (nkeys != INVALID_KEY)
    w = hit.to(torch.float32)
    n_v = vmap.count[pos] * w
    s_v = vmap.sum_pts[pos] * w[..., None]
    o_v = vmap.sum_outer[pos] * w[..., None, None]
    corners0 = decode_corner(vmap.keys, spec)
    d = torch.where(hit[..., None],
                    decode_corner(nkeys, spec) - corners0[:, None, :], 0.0)
    s_shift = s_v + n_v[..., None] * d
    o_shift = (o_v + d[..., :, None] * s_v[..., None, :]
               + s_v[..., :, None] * d[..., None, :]
               + n_v[..., None, None] * d[..., :, None] * d[..., None, :])
    cnt = n_v.sum(dim=1)
    ssum = s_shift.sum(dim=1)
    souter = o_shift.sum(dim=1)
    safe = torch.clamp(cnt, min=1.0)
    mean_local = ssum / safe[:, None]
    cov = (souter / safe[:, None, None]
           - mean_local[:, :, None] * mean_local[:, None, :])
    mean_world = torch.where(vmap.occupied_mask()[:, None],
                             corners0 + mean_local, PAD_COORD)
    return cnt, mean_world, cov


def voxel_normals_neighborhood(vmap: VoxelMap, spec: VoxelGridSpec,
                               min_count: float = 6.0,
                               planarity: float = 0.25):
    """(normals (C, 3), valid (C,)) from the 27-neighbourhood covariance."""
    cnt, _, cov = neighborhood_moments(vmap, spec)
    cov = cov + 1e-6 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    normals, planar = _smallest_normal(cov, planarity)
    return normals, vmap.occupied_mask() & (cnt >= min_count) & planar


def build_dense_lookup(vmap: VoxelMap, spec: VoxelGridSpec) -> torch.Tensor:
    """Dense cell -> slot table (2^(3 dim_bits) entries, -1 empty); keys
    are unique, so each occupied voxel writes its own entry."""
    size = 1 << (3 * spec.dim_bits)
    dev = vmap.keys.device
    table = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    idx = torch.where(vmap.occupied_mask(), vmap.keys, size).long()
    table[idx] = torch.arange(vmap.capacity, dtype=torch.int32, device=dev)
    return table[:size]


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
    mc, ms, mo = _segment_sums(seg, m, valid, nw[order], s_shift[order],
                               o_shift[order])
    # each run's largest stamp (empty segments get -inf)
    mst = _segment_max(vmap.stamp[order], seg, m, -math.inf, valid)
    mk = torch.where(mc > 0, _first_keys(k, seg, is_start, valid, m),
                     INVALID_KEY).to(torch.int32)
    order2 = torch.argsort(mk, stable=True)
    return VoxelMap(keys=mk[order2], count=mc[order2], sum_pts=ms[order2],
                    sum_outer=mo[order2], stamp=mst[order2])


def coarse_spec_of(spec: VoxelGridSpec, factor: int) -> VoxelGridSpec:
    """The lattice ``factor`` x coarser than ``spec``, same origin."""
    s = int(math.log2(factor))
    return VoxelGridSpec(leaf=spec.leaf * factor, origin=spec.origin,
                         dim_bits=spec.dim_bits - s)
