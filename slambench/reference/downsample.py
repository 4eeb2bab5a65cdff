"""Voxel-centroid downsampling via sorted segment sums.

Frozen copy of ``tpu_slam_torch.kernels.downsample``. Points are stable-
sorted by voxel key and each run of equal keys is summed with
``core.scatter.accumulate_rows`` — a sort-based, atomic-free reduction, so
results are identical run to run. Padding points each get a segment id of
their own (their sorted position, past every real segment), so no single
index collects the whole padded tail."""

from __future__ import annotations

from typing import Optional

import torch

from slambench.reference.pointcloud import PAD_COORD, PointCloud
from slambench.reference.scatter import accumulate_rows
from slambench.reference.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               segment_ids_from_sorted_keys,
                                               sort_by_key)


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Deterministic segment sum: out[s] = sum of values[i] with seg_ids[i]=s."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return accumulate_rows(out, seg_ids.long(), values)


def voxel_downsample(cloud: PointCloud, spec: VoxelGridSpec,
                     capacity: Optional[int] = None) -> PointCloud:
    """One centroid point per occupied voxel, compacted to the front."""
    n = cloud.capacity
    out_n = capacity if capacity is not None else n

    skeys, sorted_cloud = sort_by_key(cloud, spec)
    seg_ids, _ = segment_ids_from_sorted_keys(skeys)
    valid = skeys != INVALID_KEY
    pos = torch.arange(n, dtype=torch.int32, device=skeys.device)
    # real segment ids are < the valid-point count <= any padded point's
    # position, so padded points taking their own position never share an
    # index with a real voxel
    seg = torch.where(valid, seg_ids, pos)

    w = valid.to(cloud.points.dtype)
    pts = torch.where(valid[:, None], sorted_cloud.points, 0.0)
    sums = segment_sum(pts, seg, n)
    counts = segment_sum(w, seg, n)
    seg_valid = counts > 0

    safe = torch.clamp(counts, min=1.0)
    centroids = torch.where(seg_valid[:, None], sums / safe[:, None],
                            PAD_COORD)
    attrs = None
    if sorted_cloud.attrs is not None:
        a = torch.where(valid[:, None], sorted_cloud.attrs, 0.0)
        attrs = segment_sum(a, seg, n) / safe[:, None]
        attrs = torch.where(seg_valid[:, None], attrs, 0.0)

    out = PointCloud(points=centroids, mask=seg_valid, attrs=attrs).compact()
    if out_n == n:
        return out

    def fit(x, fill):
        if out_n < n:
            return x[:out_n]
        pad = torch.full((out_n - n,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    return PointCloud(points=fit(out.points, PAD_COORD),
                      mask=fit(out.mask, False),
                      attrs=None if out.attrs is None else fit(out.attrs, 0.0))
