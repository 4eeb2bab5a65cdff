"""Spatially sharded voxel map and distributed NDT registration.

Port of ``tpu_slam.distributed.map_shard``. At outdoor scale the map
outgrows one device, so:

  * voxels are split into **x-slabs**: rank d owns the cells whose x cell
    coordinate falls in its contiguous range (packed keys order x first,
    so each rank's voxel list stays sorted and self-contained);
  * a scan is inserted by computing its per-voxel aggregates on every rank
    (one scan is small) and merging the rank's own slab locally with
    ``insert_scan_stats``; no all-to-all;
  * NDT registration against the sharded map sums H, b and cost over the
    ranks with one all-reduce an evaluation, and the LM loop runs in
    lockstep on every rank (``registration.ndt.lm_schedule``, deciding only
    on all-reduced values).

Two tiers, chosen as the reference chooses (``terms_impl`` "auto", the
neighbourhood Gaussians, the window's x-extent divisible by the ranks into
chunks of a multiple of 8 planes, Wz a multiple of 8):

  * the **kernel tier**: every rank scatters its slab's voxel moments into
    the global dense window, one reduce-scatter along x hands rank d its
    x-chunk, one halo exchange brings the two neighbouring planes a side,
    and the rank builds its chunk's field rows plus one halo plane a side
    (``chunk_field_rows``), bit-identical to those planes of the
    single-device field. Scan points are split by **point ownership**: a
    rank bins only the points whose cell at the stage-entry pose lies in
    its own planes (``build_terms_raster(own_x=...)``), so every slot sees
    all 27 neighbours on its own rank, the ranks' slot lists partition the
    single-device list, and the terms are the ``ndt_terms`` kernel
    (csrc/ndt_terms.cu) on each rank's share. H, b and cost are the
    single-device sums up to summation order, and the matched count is
    exactly the single-device count. (The reference partitions by
    Gaussian ownership and counts a point only on the rank that owns its
    cell, which undercounts points matched across a chunk seam; the port
    does not copy that.)
  * the **fallback tier**: each rank builds the sparse 27-neighbourhood
    Gaussians of its own slab (voxels at a slab face see the neighbours in
    their own slab only, 18 of 27, as the reference's do), the per-point
    matched indicator is all-reduced so a point matched on two ranks
    counts once.

The reference's packed-row window tier (``_window_field_local``) exists
for the TPU's gather cost and is not ported, as the single-device port
leaves out the packed tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core.consts import const
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import mesh as mesh_mod
from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam_torch.mapping.voxel_map import (VoxelMap, decode_corner,
                                              empty_map, insert_scan_stats,
                                              scan_to_voxel_stats)
from tpu_slam_torch.registration.ndt import (NDTField, NDTParams, NDTResult,
                                             _ndt_point_terms, lm_schedule,
                                             ndt_field)

MAP_FIELDS = ("keys", "count", "sum_pts", "sum_outer", "stamp")


@dataclasses.dataclass(frozen=True)
class ShardedVoxelMap:
    """This rank's slab of a map sharded over ``n_shards`` ranks. The
    reference stacks every device's map on a leading (D, ...) axis;
    ``to_stacked`` / ``from_stacked`` carry one form to the other."""

    shard: VoxelMap
    rank: int
    n_shards: int

    @property
    def shard_capacity(self) -> int:
        return self.shard.capacity

    def local(self, d: Optional[int] = None) -> VoxelMap:
        if d is not None and d != self.rank:
            raise ValueError(f"rank {self.rank} holds shard {self.rank}, "
                             f"not {d}")
        return self.shard


def empty_sharded_map(mesh: mesh_mod.Mesh,
                      shard_capacity: int) -> ShardedVoxelMap:
    return ShardedVoxelMap(empty_map(shard_capacity, device=mesh.device),
                           mesh.rank, mesh.size)


def from_stacked(mesh: mesh_mod.Mesh, stacked: Dict[str, np.ndarray]
                 ) -> ShardedVoxelMap:
    """This rank's shard of a (D, C, ...) stacked map (numpy arrays under
    the names of ``MAP_FIELDS``)."""
    from tpu_slam_torch.mapping.voxel_map import voxel_map_from_numpy

    if stacked["keys"].shape[0] != mesh.size:
        raise ValueError(f"{stacked['keys'].shape[0]} shards for "
                         f"{mesh.size} ranks")
    shard = voxel_map_from_numpy(*(stacked[f][mesh.rank]
                                   for f in MAP_FIELDS), device=mesh.device)
    return ShardedVoxelMap(shard, mesh.rank, mesh.size)


def to_stacked(mesh: mesh_mod.Mesh, smap: ShardedVoxelMap
               ) -> Dict[str, torch.Tensor]:
    """Every rank's shard stacked on a leading (D, ...) axis (one
    all-gather a field; every rank gets the whole map)."""
    out = {}
    for f in MAP_FIELDS:
        x = getattr(smap.shard, f)
        out[f] = mesh_mod.all_gather(mesh, x[None])
    return out


def slab_owner(keys: torch.Tensor, spec: VoxelGridSpec,
               n_shards: int) -> torch.Tensor:
    """Rank owning each key (contiguous x-slabs of the cell grid); -1 for
    INVALID_KEY."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    ix = (keys >> (2 * b)) & (n - 1)
    cells_per_shard = -(-n // n_shards)
    owner = torch.div(ix, cells_per_shard, rounding_mode="floor")
    return torch.where(keys == INVALID_KEY, -1, owner).to(keys.dtype)


def insert_cloud_sharded(mesh: mesh_mod.Mesh, smap: ShardedVoxelMap,
                         cloud: PointCloud, spec: VoxelGridSpec,
                         stamp: float, axis_name: Optional[str] = None
                         ) -> ShardedVoxelMap:
    """Integrate a world-frame cloud (the same on every rank)."""
    keys, cnt, ssum, souter = scan_to_voxel_stats(cloud, spec)
    mine = slab_owner(keys, spec, mesh.size) == mesh.rank
    merged = insert_scan_stats(
        smap.shard, torch.where(mine, keys, INVALID_KEY),
        torch.where(mine, cnt, 0.0), torch.where(mine[:, None], ssum, 0.0),
        torch.where(mine[:, None, None], souter, 0.0), stamp)
    return ShardedVoxelMap(merged, smap.rank, smap.n_shards)


def _local_field(local: VoxelMap, spec: VoxelGridSpec,
                 params: NDTParams) -> NDTField:
    """The fallback tier's rank-local field: the sparse views of the slab
    (27-neighbourhood moments within the slab, floored inverses)."""
    return ndt_field(local, spec, dataclasses.replace(
        params, terms_impl="xla", window_dims=None))


def chunk_field_rows(mesh: mesh_mod.Mesh, chunk: torch.Tensor,
                     origin_cell: torch.Tensor,
                     dims: Tuple[int, int, int], spec: VoxelGridSpec,
                     min_voxel_count: float, evec_floor_ratio: float,
                     count_floor: float) -> torch.Tensor:
    """Field rows of this rank's x-chunk and one halo plane a side.

    ``chunk`` (S, Wy, Wz, 11): the raw corner moments of the window's
    planes [r S, (r + 1) S) and an occupied flag; ``origin_cell`` and
    ``dims`` are the whole window's. One halo exchange brings two planes
    from each neighbour (zeros beyond the window's ends), then
    ``field_rows`` runs on the S + 4 planes and the middle S + 2 are
    kept: the 27-cell sums of the kept planes see every neighbour, so the
    rows are bit-identical to those planes of ``field_rows`` over the whole
    window (the halo planes being the neighbours' finished rows). Returns
    ((S + 2) Wy Wz, 16) rows, local plane 0 = window plane r S - 1.
    """
    from tpu_slam_torch.mapping.dense_map import field_rows

    s, wy, wz = chunk.shape[:3]
    if s < 2:
        raise ValueError("an x-chunk needs at least 2 planes")
    left, right = mesh_mod.halo_exchange(mesh, chunk[:2].contiguous(),
                                         chunk[-2:].contiguous())
    ext = torch.cat([left, chunk, right], dim=0)
    dev = chunk.device
    oc = origin_cell + const((mesh.rank * s - 2, 0, 0), origin_cell.dtype,
                             dev)
    rows = field_rows(ext[..., :10].reshape(-1, 10),
                      ext[..., 10].reshape(-1) > 0.5, oc, (s + 4, wy, wz),
                      spec, min_voxel_count, evec_floor_ratio, count_floor)
    return rows[wy * wz:(s + 3) * wy * wz].contiguous()


def window_corner(mesh: mesh_mod.Mesh, local: VoxelMap, spec: VoxelGridSpec,
                  dims: Tuple[int, int, int],
                  center: Optional[torch.Tensor]) -> torch.Tensor:
    """The window's corner cell, as ``_ndt_field_dense`` places it (the
    map's centroid, all-reduced over the slabs, when ``center`` is None)."""
    n = spec.cells_per_axis
    wx, wy, wz = dims
    dev = local.keys.device
    f32 = torch.float32
    if wx >= n and wy >= n and wz >= n:
        return torch.zeros(3, dtype=torch.int32, device=dev)
    if center is None:
        occ = local.occupied_mask()
        corners = decode_corner(local.keys, spec)
        part = torch.cat([
            torch.where(occ, local.count, 0.0).sum()[None],
            torch.where(occ[:, None],
                        corners * local.count[:, None] + local.sum_pts,
                        0.0).sum(dim=0)])
        tot = mesh_mod.all_reduce(mesh, part)
        center = tot[1:] / torch.clamp(tot[0], min=1.0)
    cc = torch.floor((torch.as_tensor(center, dtype=f32, device=dev)
                      - spec.origin_tensor(dev)) / spec.leaf).to(torch.int32)
    half = torch.tensor([wx // 2, wy // 2, wz // 2], dtype=torch.int32,
                        device=dev)
    hi = torch.tensor([n - wx, n - wy, n - wz], dtype=torch.int32,
                      device=dev)
    return torch.minimum(torch.clamp(cc - half, min=0), hi)


def window_rows_local(mesh: mesh_mod.Mesh, local: VoxelMap,
                      spec: VoxelGridSpec, params: NDTParams,
                      dims: Tuple[int, int, int],
                      center: Optional[torch.Tensor]):
    """The kernel tier's field: this rank's chunk rows (``chunk_field_rows``)
    of the dense window ``dims`` over the whole sharded map, and the
    window's corner cell.

    Each rank scatters its slab's voxels into the whole window (one row a
    voxel), and a reduce-scatter along x sums the ranks' windows (a merge:
    the slabs are disjoint) into each rank's x-chunk.
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    wx, wy, wz = dims
    s = wx // mesh.size
    g = wx * wy * wz
    dev = local.keys.device
    f32 = torch.float32
    c0 = window_corner(mesh, local, spec, dims, center)
    occ = local.occupied_mask()
    keys = local.keys
    lx = ((keys >> (2 * b)) & (n - 1)) - c0[0]
    ly = ((keys >> b) & (n - 1)) - c0[1]
    lz = (keys & (n - 1)) - c0[2]
    inside = (occ & (lx >= 0) & (lx < wx) & (ly >= 0) & (ly < wy)
              & (lz >= 0) & (lz < wz))
    lidx = torch.where(inside, (lx * wy + ly) * wz + lz, g).long()
    so = local.sum_outer
    chan = torch.cat([
        local.count[:, None], local.sum_pts,
        so[:, 0, 0:1], so[:, 0, 1:2], so[:, 0, 2:3],
        so[:, 1, 1:2], so[:, 1, 2:3], so[:, 2, 2:3],
        torch.ones((local.capacity, 1), dtype=f32, device=dev)], dim=1)
    chan = torch.where(inside[:, None], chan, 0.0)
    dm = torch.zeros((g + 1, 11), dtype=f32, device=dev)
    dm[lidx] = chan
    chunk = mesh_mod.reduce_scatter(mesh, dm[:g].reshape(wx, wy * wz * 11))
    del dm
    rows = chunk_field_rows(mesh, chunk.reshape(s, wy, wz, 11), c0, dims,
                            spec, params.min_voxel_count,
                            params.evec_floor_ratio, count_floor=1.0)
    return rows, c0


def kernel_tier_fns(mesh: mesh_mod.Mesh, src: PointCloud,
                    rows_local: torch.Tensor, c0: torch.Tensor,
                    dims: Tuple[int, int, int], spec: VoxelGridSpec,
                    params: NDTParams):
    """(raw_terms, bin_raster, yaw_cost) of the kernel tier for
    ``lm_schedule``: point-ownership binning into the rank's local window,
    the ``ndt_terms`` kernel on its share, one all-reduce an evaluation."""
    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster, ndt_terms

    wx, wy, wz = dims
    s = wx // mesh.size
    dims_local = (s + 2, wy, wz)
    own = (mesh.rank * s, (mesh.rank + 1) * s)
    dev = src.points.device
    origin_w = spec.origin_tensor(dev) + c0.to(torch.float32) * spec.leaf
    n_src = torch.clamp(src.mask.sum(dtype=torch.float32), min=1.0)

    def bin_raster(T0):
        return build_terms_raster(src.points, src.mask, T0, origin_w,
                                  spec.leaf, dims, params.raster_q,
                                  own_x=own)[0]

    def raw_terms(T, gamma, slots):
        H, b, cost, cnt = ndt_terms(slots, rows_local, T, gamma,
                                    params.max_corr_dist, dims_local)
        # one all-reduce of 44 floats; the matched count is exact
        v = mesh_mod.all_reduce(mesh, torch.cat([
            H.reshape(-1), b, cost.reshape(1), cnt.reshape(1)]))
        return v[:36].reshape(6, 6), v[36:42], v[42], v[43] / n_src

    def yaw_cost(Ty, gamma_y):
        return raw_terms(Ty, gamma_y, bin_raster(Ty))[2]

    return raw_terms, bin_raster, yaw_cost


def ndt_register_sharded(mesh: mesh_mod.Mesh, source: PointCloud,
                         smap: ShardedVoxelMap, spec: VoxelGridSpec,
                         init_T: Optional[torch.Tensor] = None,
                         params: NDTParams = NDTParams(),
                         axis_name: Optional[str] = None,
                         center: Optional[torch.Tensor] = None
                         ) -> NDTResult:
    """NDT registration of a (replicated) source cloud against the sharded
    map; every rank returns the same result.

    The window is ``params.window_dims``, else the cube of
    2^min(dim_bits, window_bits) cells, placed at ``center`` (default: the
    map's centroid) as ``ndt_field`` places it.
    """
    if axis_name is not None and axis_name != mesh.axis_name:
        raise ValueError(f"mesh axis is {mesh.axis_name!r}")
    dev = source.points.device
    f32 = torch.float32
    if init_T is None:
        init_T = torch.eye(4, dtype=f32, device=dev)
    src = source.sanitize()
    n_src = torch.clamp(src.mask.sum(dtype=f32), min=1.0)
    n = spec.cells_per_axis
    if params.window_dims is not None:
        dims = tuple(min(d, n) for d in params.window_dims)
    else:
        dims = (1 << min(spec.dim_bits, params.window_bits),) * 3
    # the reference's tier condition for its raster kernel
    ranks = mesh.size
    if (params.terms_impl == "auto" and params.use_neighborhood
            and dims[0] % ranks == 0 and (dims[0] // ranks) % 8 == 0
            and dims[2] % 8 == 0):
        rows_local, c0 = window_rows_local(mesh, smap.shard, spec, params,
                                           dims, center)
        raw_terms, bin_raster, yaw_cost = kernel_tier_fns(
            mesh, src, rows_local, c0, dims, spec, params)
        T, iters, frac, cost, dx = lm_schedule(init_T, params, True,
                                               raw_terms, bin_raster,
                                               yaw_cost)
    else:
        field = _local_field(smap.shard, spec, params)

        def raw_terms(T, gamma, isotropic):
            H, b, cost, match = _ndt_point_terms(src, T, field, spec,
                                                 params, gamma, isotropic)
            # a point matched on several ranks (its 27-neighbourhood
            # straddles a slab face) counts once
            v = mesh_mod.all_reduce(mesh, torch.cat([
                H.reshape(-1), b, cost.reshape(1), match.to(H.dtype)]))
            frac = torch.clamp(v[43:], max=1.0).sum() / n_src
            return v[:36].reshape(6, 6), v[36:42], v[42], frac

        T, iters, frac, cost, dx = lm_schedule(init_T, params, False,
                                               raw_terms, None, None)
    return NDTResult(T=T, iterations=iters, score=-cost / n_src,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)
