"""The port's dense moment window against tpu_slam.mapping.dense_map (CPU).

Insert, scroll, the recentre deadband and the window-corner rule (floor
division and the jnp.clip rule when the window is wider than the grid),
and the NDT field rows against the reference's plane tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.kernels.ndt_terms import rows_to_planes
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.mapping import dense_map as jdm
from tpu_slam.mapping.voxel_map import coarse_spec_of as j_coarse_spec_of
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import dense_map as dm
from tpu_slam_torch.mapping.voxel_map import coarse_spec_of

SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
JSPEC = JSpec.centered(leaf=0.5, half_extent=16.0)
DIMS = (16, 16, 8)
ORIGIN_CELL = (20, 22, 28)


def _cloud(seed=0, n=1500, cap=2048):
    """World points over and around the window (some outside, padding)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(SPEC.origin) + np.asarray(ORIGIN_CELL) * SPEC.leaf
    hi = lo + np.asarray(DIMS) * SPEC.leaf
    pts = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
    return (JCloud.from_points_host(pts, capacity=cap),
            PointCloud.from_points_host(pts, capacity=cap, device="cpu"))


def _grids(jc, tc, weight=1.0):
    jg = jdm.grid_insert(jdm.empty_grid(DIMS, jnp.asarray(ORIGIN_CELL)), jc,
                         JSPEC, weight=weight)
    tg = dm.grid_insert(dm.empty_grid(DIMS, ORIGIN_CELL), tc, SPEC,
                        weight=torch.tensor(weight))
    return jg, tg


@pytest.mark.parametrize("weight", [1.0, 0.0])
def test_grid_insert_matches_reference(weight):
    jc, tc = _cloud()
    jg, tg = _grids(jc, tc, weight)
    # per-cell float32 sums in input order on both sides; the reference
    # segment-sums first and adds once, the port adds point by point
    np.testing.assert_allclose(tg.rows.numpy(), np.asarray(jg.rows),
                               rtol=1e-5, atol=1e-5)
    assert (float(tg.rows[:, 0].sum()) > 0) == (weight > 0)


def test_grid_scroll_matches_reference():
    jc, tc = _cloud(1)
    for shift in ([4, -4, 0], [0, 0, 0], [-3, 17, 2], [1, 1, -9]):
        jg, tg = _grids(jc, tc)
        jg2 = jdm.grid_scroll(jg, jnp.asarray(shift, jnp.int32))
        tg2 = dm.grid_scroll(tg, torch.tensor(shift, dtype=torch.int32))
        np.testing.assert_array_equal(tg2.origin_cell.numpy(),
                                      np.asarray(jg2.origin_cell))
        np.testing.assert_allclose(tg2.rows.numpy(), np.asarray(jg2.rows),
                                   rtol=1e-5, atol=1e-5)


CENTERS = [(5.3, -2.1, 0.4), (-15.9, -7.77, -3.3), (0.0, 0.0, 0.0),
           (40.0, -40.0, 2.0), (-0.26, -0.24, -0.01)]


@pytest.mark.parametrize("align", [1, 2, 4])
def test_centered_origin_and_recenter_match_reference(align):
    jg = jdm.empty_grid(DIMS, jnp.asarray(ORIGIN_CELL))
    tg = dm.empty_grid(DIMS, ORIGIN_CELL)
    for c in CENTERS:
        cw = np.asarray(c, np.float32)
        ref = np.asarray(jdm.centered_origin_cell(jnp.asarray(cw), JSPEC,
                                                  DIMS, align))
        got = dm.centered_origin_cell(torch.as_tensor(cw), SPEC, DIMS, align)
        np.testing.assert_array_equal(got.numpy(), ref)
        for frac in (0.25, 0.0):
            rs = jdm.grid_recenter_shift(jg, jnp.asarray(cw), JSPEC, align,
                                         frac)
            ts = dm.grid_recenter_shift(tg, torch.as_tensor(cw), SPEC,
                                        align, frac)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


def test_wide_window_corner_clips_below_zero():
    """Config 2's wide window: 192 cells at 2 m on a 128-cell coarse grid.

    The clip's upper bound (128 - 192 = -64) is below its lower bound 0;
    like jnp.clip the upper bound wins, so the x/y corner sits at -64.
    """
    fine = VoxelGridSpec.centered(leaf=0.5, half_extent=128.0)
    spec = coarse_spec_of(fine, 4)
    jspec = j_coarse_spec_of(JSpec.centered(leaf=0.5, half_extent=128.0), 4)
    assert (spec.leaf, spec.origin, spec.dim_bits) == (
        jspec.leaf, jspec.origin, jspec.dim_bits) == (2.0, (-128.0,) * 3, 7)
    dims = (192, 192, 32)
    for c in [(-14.0, -4.0, 1.8), (-4.0, 20.0, 1.8), (90.0, -90.0, 0.0)]:
        cw = np.asarray(c, np.float32)
        got = dm.centered_origin_cell(torch.as_tensor(cw), spec, dims, 1)
        ref = jdm.centered_origin_cell(jnp.asarray(cw), jspec, dims, 1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got[0] == -64 and got[1] == -64


def test_grid_ndt_field_rows_match_reference_planes():
    jc, tc = _cloud(2, n=1800)
    jg, tg = _grids(jc, tc)
    jf = jdm.grid_ndt_field(jg, JSPEC, min_voxel_count=3.0)
    tf = dm.grid_ndt_field(tg, SPEC, min_voxel_count=3.0)
    assert tf.window_dims == DIMS and tf.rows.shape == (np.prod(DIMS), 16)
    # the reference's (Wx, 16, 8, Wy*Wz/8) planes back to x-major rows
    planes = np.asarray(jf.planes).reshape(DIMS[0], 16, 8, DIMS[1],
                                           DIMS[2] // 8)
    ref = planes.transpose(0, 3, 4, 2, 1).reshape(-1, 16)
    got = tf.rows.numpy()
    # valid flags are integer decisions on the cell count; through the
    # reference's own layout helper they land on its valid plane
    np.testing.assert_array_equal(got[:, 9], ref[:, 9])
    np.testing.assert_array_equal(
        np.asarray(rows_to_planes(jnp.asarray(got), DIMS))[:, 9],
        np.asarray(jf.planes)[:, 9])
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=1e-5)
    # the information entries of a near-planar cell reach 1/(0.01
    # lambda_max) on one axis and are small on others; float32 moments
    # summed in another order move each entry by ~1e-4 of the cell's
    # largest entry
    info_scale = np.abs(ref[:, 3:9]).max(axis=1, keepdims=True)
    assert np.all(np.abs(got[:, 3:9] - ref[:, 3:9]) <= 1e-4 * info_scale
                  + 1e-6)
    assert float(tf.rows[:, 9].sum()) > 20


@pytest.mark.parametrize("max_out", [None, 300])
def test_grid_to_sparse_aggregates_matches_reference(max_out):
    """The same window rows (the reference's) on both sides: keys and
    counts exact, sums and outer products bit-equal (a permutation)."""
    jc, _ = _cloud()
    jg = jdm.grid_insert(jdm.empty_grid(DIMS, jnp.asarray(ORIGIN_CELL)), jc,
                         JSPEC)
    tg = dm.DenseMomentGrid(rows=torch.as_tensor(np.array(jg.rows)),
                            origin_cell=torch.tensor(ORIGIN_CELL,
                                                     dtype=torch.int32),
                            dims=DIMS)
    got = dm.grid_to_sparse_aggregates(tg, SPEC, max_out=max_out)
    ref = jdm.grid_to_sparse_aggregates(jg, JSPEC, max_out=max_out)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int32
    n_occ = int((tg.rows[:, 0] > 0).sum())
    assert 0 < n_occ < DIMS[0] * DIMS[1] * DIMS[2]
    assert (got[0][:n_occ] != 2 ** 31 - 1).all()


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunk_inserts_tile_the_window_bit_for_bit(n_chunks):
    """insert_rows on x-chunks (the sharded dense step's insert) gives the
    whole window's rows, plane for plane."""
    _, tc = _cloud(seed=3)
    whole = dm.grid_insert(dm.empty_grid(DIMS, ORIGIN_CELL), tc, SPEC,
                           weight=torch.tensor(1.0))
    s = DIMS[0] // n_chunks
    per = s * DIMS[1] * DIMS[2]
    oc = torch.tensor(ORIGIN_CELL, dtype=torch.int32)
    chunks = [dm.insert_rows(torch.zeros(per, 10), oc, DIMS, tc, SPEC,
                             torch.tensor(1.0), x_range=(d * s, (d + 1) * s))
              for d in range(n_chunks)]
    assert torch.equal(torch.cat(chunks), whole.rows)
