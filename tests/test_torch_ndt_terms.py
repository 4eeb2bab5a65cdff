"""The port's NDT terms pass against tpu_slam.kernels.ndt_terms (CPU).

The slot build is integer math and must match the reference raster's
nonzero slots exactly, dropped count included. ndt_terms_plain (the CUDA
kernel's plain version, which the wrapper runs for CPU tensors) is held
against ndt_terms_raster_reference on the same field and scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.kernels.ndt_terms import build_terms_raster as j_build
from tpu_slam.kernels.ndt_terms import (ndt_terms_raster_reference,
                                        raster_to_slots, rows_to_planes)
from tpu_slam_torch.kernels.ndt_terms import (TermsSlots, build_terms_raster,
                                              ndt_terms, ndt_terms_plain)

LEAF = 0.5


def _field(dims, seed=0, occupancy=0.7):
    """Random (G, 16) rows: mean near the cell center, SPD information."""
    rng = np.random.default_rng(seed)
    wx, wy, wz = dims
    g = wx * wy * wz
    cell = np.stack(np.meshgrid(np.arange(wx), np.arange(wy), np.arange(wz),
                                indexing="ij"), -1).reshape(g, 3)
    mean = (cell + 0.5) * LEAF + rng.normal(0, 0.08, (g, 3))
    a = rng.normal(0, 1, (g, 3, 3))
    cov = a @ a.transpose(0, 2, 1) * 0.01 + 0.02 * np.eye(3)
    lam = np.linalg.inv(cov)
    valid = rng.uniform(size=g) < occupancy
    iu = np.triu_indices(3)
    rows = np.zeros((g, 16), np.float32)
    rows[:, 0:3] = mean
    rows[:, 3:9] = lam[:, iu[0], iu[1]]
    rows[:, 9] = valid
    rows[~valid] = 0.0
    return rows


def _scan(dims, n, seed):
    """Points over the window, some outside it, a crowded cell, padding."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(dims) * LEAF
    pts = rng.uniform(-0.3, ext + 0.3, (n, 3)).astype(np.float32)
    pts[:12] = np.float32(0.5 * ext + 0.1)            # 12 points in one cell
    pts[12:20] = rng.uniform(0, LEAF, (8, 3))         # window corner cell
    mask = np.ones(n, bool)
    mask[-15:] = False
    pts[-15:] = 1e8
    return pts, mask


def _pose(seed, scale=0.05):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, scale, 6).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


CASES = [((8, 8, 16), 2, 300), ((16, 8, 8), 4, 600), ((8, 16, 8), 8, 500)]


@pytest.mark.parametrize("dims,q,n", CASES)
def test_slots_equal_reference_raster(dims, q, n):
    pts, mask = _scan(dims, n, seed=q)
    T0 = _pose(q)
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    raster, dropped = j_build(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(T0), jnp.asarray(origin), LEAF,
                              dims, q)
    ref = np.asarray(raster_to_slots(raster, dims, q))
    keep = ref[:, 3] > 0.5
    slots, n_dropped = build_terms_raster(_t(pts), _t(mask, torch.bool),
                                          _t(T0), _t(origin), LEAF, dims, q)
    v = slots.valid.numpy()
    assert int(n_dropped) == int(dropped) > 0
    # kept slots, in order (cell-major, then input order = rank order)
    np.testing.assert_array_equal(slots.cell.numpy()[v],
                                  np.nonzero(keep)[0] // q)
    np.testing.assert_array_equal(slots.points.numpy()[v], ref[keep, :3])
    assert int(v.sum()) + int(n_dropped) == int(mask.sum())


def _compare_terms(dims, q, n, seed, gamma, max_corr):
    rows = _field(dims, seed)
    pts, mask = _scan(dims, n, seed + 10)
    T0 = _pose(seed + 20)
    T = _pose(seed + 30, scale=0.02) @ T0
    origin = np.zeros(3, np.float32)
    raster, _ = j_build(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(T0),
                        jnp.asarray(origin), LEAF, dims, q)
    Hr, br, cr, mr = ndt_terms_raster_reference(
        raster, rows_to_planes(jnp.asarray(rows), dims), jnp.asarray(T),
        gamma, max_corr, dims, q)
    slots, _ = build_terms_raster(_t(pts), _t(mask, torch.bool), _t(T0),
                                  _t(origin), LEAF, dims, q)
    H, b, c, m = ndt_terms_plain(slots, _t(rows), _t(T), gamma, max_corr,
                                 dims)
    Hr, br = np.asarray(Hr), np.asarray(br)
    # float32 sums over different orders (slot-major here, neighbour-major
    # there): hold each output to 1e-4 of its largest magnitude
    assert np.abs(H.numpy() - Hr).max() <= 1e-4 * np.abs(Hr).max()
    assert np.abs(b.numpy() - br).max() <= 1e-4 * np.abs(br).max()
    assert abs(float(c) - float(cr)) <= 1e-4 * abs(float(cr))
    # the gate compares a float distance with a strict '<': the transform
    # is a matmul in the reference and element-wise ops here, so a pair
    # within an ulp of the gate may flip; allow 2 such slots
    assert abs(float(m) - float(mr)) <= 2
    assert float(m) > 0


@pytest.mark.parametrize("dims,q,n", CASES)
def test_plain_terms_match_reference(dims, q, n):
    _compare_terms(dims, q, n, seed=q, gamma=4.0, max_corr=1.0)


def test_plain_terms_hot_gate_and_far_corr():
    # a high temperature (the GNC stage) and the far tier's wide gate
    _compare_terms((8, 8, 16), 4, 400, seed=7, gamma=64.0, max_corr=4.0)


def test_wrapper_dispatches_cpu_to_plain_and_counts():
    dims, q = (8, 8, 16), 2
    rows = _field(dims, 3)
    pts, mask = _scan(dims, 200, 4)
    slots, _ = build_terms_raster(_t(pts), _t(mask, torch.bool),
                                  torch.eye(4), torch.zeros(3), LEAF, dims, q)
    before_plain, before_kernel = ndt_terms_plain.launches, ndt_terms.launches
    out = ndt_terms(slots, _t(rows), torch.eye(4), 4.0, 1.0, dims)
    ref = ndt_terms_plain(slots, _t(rows), torch.eye(4), 4.0, 1.0, dims)
    assert ndt_terms_plain.launches == before_plain + 2
    assert ndt_terms.launches == before_kernel      # no kernel on the CPU
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # an empty slot list is a valid input and scores nothing
    empty = TermsSlots(points=torch.zeros(0, 3),
                       cell=torch.zeros(0, dtype=torch.int32),
                       valid=torch.zeros(0, dtype=torch.bool),
                       inside=torch.zeros(0, dtype=torch.bool))
    H, b, c, m = ndt_terms(empty, _t(rows), torch.eye(4), 4.0, 1.0, dims)
    assert float(H.abs().sum()) == 0 and float(c) == 0 and float(m) == 0


def test_wrapper_rejects_bad_inputs():
    dims = (8, 8, 16)
    rows = torch.as_tensor(_field(dims, 5))
    slots, _ = build_terms_raster(torch.zeros(4, 3), torch.ones(4,
                                                              dtype=torch.bool),
                                  torch.eye(4), torch.zeros(3), LEAF, dims, 2)
    with pytest.raises(ValueError):
        ndt_terms(slots, rows.double(), torch.eye(4), 4.0, 1.0, dims)
    with pytest.raises(ValueError):
        ndt_terms(slots, rows[:-1], torch.eye(4), 4.0, 1.0, dims)
    with pytest.raises(ValueError):
        ndt_terms(slots, rows, torch.eye(4).T, 4.0, 1.0, dims)
    with pytest.raises(TypeError):
        ndt_terms(slots, rows, torch.eye(4), torch.tensor(4.0), 1.0, dims)
