"""Sort-based voxel grid hashing.

Port of ``tpu_slam.kernels.voxel_hash``: quantize points to integer cells,
pack the three cell coordinates into one int32 key, and stable-sort by key;
runs of equal keys are the voxels. Cell math floors like ``jnp.floor``
(negative coordinates included), and out-of-grid points get INVALID_KEY.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tpu_slam_torch.core.pointcloud import PointCloud

# Invalid/padding points get the maximum key so they sort to the end.
INVALID_KEY = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class VoxelGridSpec:
    """Static description of a bounded voxel grid (2**dim_bits cells/axis)."""

    leaf: float
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dim_bits: int = 10

    def __post_init__(self):
        if 3 * self.dim_bits > 31:
            raise ValueError("3 * dim_bits must fit in int32")

    @property
    def cells_per_axis(self) -> int:
        return 1 << self.dim_bits

    @property
    def extent(self) -> float:
        return self.leaf * self.cells_per_axis

    def origin_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.origin, dtype=torch.float32, device=device)

    @staticmethod
    def centered(leaf: float, half_extent: float,
                 max_bits: int = 10) -> "VoxelGridSpec":
        """Grid centered on the world origin covering +-half_extent."""
        bits = 1
        while leaf * (1 << bits) < 2.0 * half_extent:
            bits += 1
        if bits > max_bits:
            raise ValueError(
                f"grid of half_extent={half_extent} at leaf={leaf} needs "
                f"2^{bits} cells/axis > the 2^{max_bits} int32-key cap; use a "
                f"coarser leaf (>= {2.0 * half_extent / (1 << max_bits):.3f}) "
                f"or a scrolling window centered on the trajectory")
        ext = leaf * (1 << bits)
        return VoxelGridSpec(leaf=leaf, origin=(-ext / 2, -ext / 2, -ext / 2),
                             dim_bits=bits)


def cell_coords(points: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """(N, 3) points -> (N, 3) int32 cell coordinates (may be out of bounds)."""
    origin = spec.origin_tensor(points.device)
    return torch.floor((points - origin) / spec.leaf).to(torch.int32)


def pack_key(coords: torch.Tensor, spec: VoxelGridSpec) -> torch.Tensor:
    """Pack (N, 3) int cell coords into int32 keys; out-of-grid -> INVALID."""
    n = spec.cells_per_axis
    in_bounds = ((coords >= 0) & (coords < n)).all(dim=-1)
    b = spec.dim_bits
    key = ((coords[..., 0] << (2 * b)) | (coords[..., 1] << b)
           | coords[..., 2])
    return torch.where(in_bounds, key, INVALID_KEY).to(torch.int32)


def voxel_keys(cloud: PointCloud, spec: VoxelGridSpec) -> torch.Tensor:
    """(N,) int32 voxel key per point; invalid points -> INVALID_KEY."""
    key = pack_key(cell_coords(cloud.points, spec), spec)
    return torch.where(cloud.mask, key, INVALID_KEY).to(torch.int32)


def sort_by_key(cloud: PointCloud, spec: VoxelGridSpec
                ) -> Tuple[torch.Tensor, PointCloud]:
    """Stable sort of a cloud by voxel key: (sorted_keys, sorted_cloud)."""
    keys = voxel_keys(cloud, spec)
    order = torch.argsort(keys, stable=True)
    attrs = None if cloud.attrs is None else cloud.attrs[order]
    return keys[order], PointCloud(points=cloud.points[order],
                                   mask=cloud.mask[order], attrs=attrs)


def segment_ids_from_sorted_keys(sorted_keys: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense segment ids for runs of equal sorted keys.

    Returns (segment_ids int32, is_segment_start bool). Invalid-key tail
    points share the trailing segment ids; callers mask them by key.
    """
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg_ids = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32) - 1
    return seg_ids, is_start
