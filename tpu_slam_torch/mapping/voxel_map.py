"""Grid-spec helpers of ``tpu_slam.mapping.voxel_map`` (the sparse voxel map
itself is not ported yet)."""

from __future__ import annotations

import math

from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec


def coarse_spec_of(spec: VoxelGridSpec, factor: int) -> VoxelGridSpec:
    """The lattice ``factor`` x coarser than ``spec``, same origin."""
    s = int(math.log2(factor))
    return VoxelGridSpec(leaf=spec.leaf * factor, origin=spec.origin,
                         dim_bits=spec.dim_bits - s)
