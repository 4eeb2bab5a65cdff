"""tpu_slam_torch voxel hashing and downsampling against tpu_slam (CPU).

Keys, the stable sort and segment ids are integer math and must agree
exactly; centroids are float sums in another order (atol 1e-5 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.kernels.downsample import voxel_downsample as j_downsample
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.kernels.voxel_hash import (segment_ids_from_sorted_keys as
                                         j_segment_ids)
from tpu_slam.kernels.voxel_hash import sort_by_key as j_sort_by_key
from tpu_slam.kernels.voxel_hash import voxel_keys as j_voxel_keys
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                               segment_ids_from_sorted_keys,
                                               sort_by_key, voxel_keys)


def _clouds(seed, n=3000, cap=4096, extent=20.0):
    """The same cloud for both packages: negative coordinates, points
    outside the grid, duplicates in cells, and padding."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pts[: n // 4] = np.round(pts[: n // 4] * 2) / 2 + 0.01    # crowd cells
    pts[-10:] = 300.0                                          # off-grid
    jc = JCloud.from_points_host(pts, capacity=cap)
    tc = PointCloud.from_points_host(pts, capacity=cap, device="cpu")
    return jc, tc


@pytest.mark.parametrize("leaf,half", [(0.3, 16.0), (1.0, 32.0)])
def test_keys_sort_segments_exact(leaf, half):
    jc, tc = _clouds(0)
    jspec = JSpec.centered(leaf=leaf, half_extent=half)
    spec = VoxelGridSpec.centered(leaf=leaf, half_extent=half)
    assert (spec.origin, spec.dim_bits) == (jspec.origin, jspec.dim_bits)
    np.testing.assert_array_equal(voxel_keys(tc, spec).numpy(),
                                  np.asarray(j_voxel_keys(jc, jspec)))
    jk, jsorted = j_sort_by_key(jc, jspec)
    tk, tsorted = sort_by_key(tc, spec)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tsorted.points.numpy(),
                                  np.asarray(jsorted.points))
    jseg, jstart = j_segment_ids(jk)
    seg, start = segment_ids_from_sorted_keys(tk)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
    assert int((tk == INVALID_KEY).sum()) >= 10 + 4096 - 3000


@pytest.mark.parametrize("leaf,capacity", [(0.3, None), (0.5, 2048),
                                           (2.0, 8192)])
def test_voxel_downsample_matches_reference(leaf, capacity):
    jc, tc = _clouds(1)
    jspec = JSpec.centered(leaf=leaf, half_extent=32.0)
    spec = VoxelGridSpec.centered(leaf=leaf, half_extent=32.0)
    ref = j_downsample(jc, jspec, capacity=capacity)
    got = voxel_downsample(tc, spec, capacity=capacity)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=1e-5)


def test_downsample_attrs_and_empty_cloud():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    attrs = rng.uniform(0, 1, (500, 2)).astype(np.float32)
    jspec = JSpec.centered(leaf=0.5, half_extent=8.0)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=8.0)
    ref = j_downsample(JCloud.from_points_host(pts, 512, attrs=attrs), jspec)
    got = voxel_downsample(PointCloud.from_points_host(pts, 512, attrs=attrs,
                                                       device="cpu"), spec)
    np.testing.assert_allclose(got.attrs.numpy(), np.asarray(ref.attrs),
                               atol=1e-6)
    empty = PointCloud(points=torch.full((64, 3), 1e8),
                       mask=torch.zeros(64, dtype=torch.bool))
    out = voxel_downsample(empty, spec, capacity=32)
    assert out.points.shape == (32, 3) and not bool(out.mask.any())
    jempty = j_downsample(JCloud(points=jnp.full((64, 3), 1e8),
                                 mask=jnp.zeros(64, bool)), jspec, capacity=32)
    np.testing.assert_array_equal(out.points.numpy(),
                                  np.asarray(jempty.points))
