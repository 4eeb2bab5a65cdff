"""The terms kernels' decompositions, in their plain models (CPU).

``csrc/ndt_terms.cu`` and ``csrc/icp_terms.cu`` split each slot's work
across a group of lanes, walk the slots with a grid of a fixed number of
blocks and sum the blocks' rows in a one-block finalizer. Their plain
models (``lane_split_plain``, ``lane_scan_plain``, ``grid_partials_plain``,
``finalize_plain``) fix which lane, group and block see each term and the
order of every sum; here they are held against the plain versions on seeded
inputs: matched counts and each slot's chosen ICP target exactly equal, and
each block of H, each half of b and each scalar sum within 1e-6 of that
block's largest magnitude. Where a block's terms cancel (its largest sum of
absolute terms is over twice its largest magnitude) the bound is 1e-6 of
that sum of absolute terms instead: float32 sums in another order round at
the scale of the terms, not of the result (b_r's terms cancel 121-fold at
1,000 slots, and the plain version's own einsum is 3.5e-4 off the float64
sum in such a case).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_slam_torch.kernels import icp_terms as I
from tpu_slam_torch.kernels import ndt_terms as N
from tpu_slam_torch.kernels.ndt_terms import (TermsSlots, build_terms_raster,
                                              raster_to_slots)

LANES = [1, 4, 8, 32]
SLOTS = [0, 1, 7, 1000]
RTOL = 1e-6
CANCELS = 2.0   # sum of absolute terms over the block maximum


def _first(slots: TermsSlots, n: int) -> TermsSlots:
    return TermsSlots(points=slots.points[:n].contiguous(),
                      cell=slots.cell[:n].contiguous(),
                      valid=slots.valid[:n].contiguous(),
                      inside=slots.inside[:n].contiguous())


def _close(got, ref, scale, blocks):
    """Each block of ``got`` within RTOL of the block's largest magnitude in
    ``ref``, or, where the block cancels, of its largest entry of ``scale``
    (the totals of the absolute per-slot terms)."""
    for (label, a), (_, b), (_, s) in zip(blocks(got), blocks(ref),
                                          blocks(scale)):
        err = float((a - b).abs().max())
        top = max(float(b.abs().max()), 1e-30)
        terms = float(s.abs().max())
        assert err <= RTOL * (terms if terms > CANCELS * top else top), label


def _ndt_totals(tot):
    return tot[:21][N._sym_index(tot.device)], tot[21:27], tot[27], tot[28]


def _ndt_case(n):
    # the seeded edge case (gate-edge pairs, a crowded cell, window-corner
    # cells, padding), its slot list cut to its first n slots: those of the
    # lowest cells, on the x = 0 face
    slots, rows, T, gamma, corr, dims = chip_smoke.random_terms_case(
        "cpu", dims=(12, 10, 8), n=1200, seed=n)
    return (_first(slots, n), rows, T, gamma, corr, dims)


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("lanes", LANES)
def test_ndt_lane_split_matches_plain(lanes, n):
    args = _ndt_case(n)
    ref = N.ndt_terms_plain(*args)
    scale = _ndt_totals(N.lane_split_plain(*args, lanes=1).abs().sum(dim=0))
    # the card's grid, and a grid of two blocks, where each group walks
    # several slots
    for max_blocks in (N.MAX_BLOCKS, 2):
        got = N.ndt_terms_model(*args, lanes=lanes, max_blocks=max_blocks)
        assert float(got[3]) == float(ref[3])
        _close(got, ref, scale, chip_smoke.terms_blocks)
    if n == 1000:
        assert float(ref[3]) > 0


def test_ndt_gate_edges_and_channels():
    # the per-slot channels sum to the plain version's H, b and cost, and a
    # slot counts as matched exactly when one of its neighbours passes the
    # gate, the pairs set a few ulp either side of max_corr_dist included
    args = chip_smoke.random_terms_case("cpu", seed=3)
    per_slot = N.lane_split_plain(*args, lanes=8)
    ref = N.ndt_terms_plain(*args)
    tot = _ndt_totals(per_slot.sum(dim=0))
    assert float(tot[3]) == float(ref[3])
    _close((tot[0], tot[1], -tot[2]), ref,
           _ndt_totals(per_slot.abs().sum(dim=0)), chip_smoke.terms_blocks)
    assert bool(((per_slot[:, 28] == 0) | (per_slot[:, 28] == 1)).all())


def test_grid_and_finalizer_models():
    # the grid gives each slot to exactly one group and the finalizer sums
    # every block's row: on integers (exact in float32) the total is exact
    rng = np.random.default_rng(0)
    per_slot = torch.as_tensor(rng.integers(-50, 50, (3001, 5)),
                               dtype=torch.float32)
    for lanes in LANES:
        for max_blocks in (1, 3, 1000):
            nb = N.grid_blocks(per_slot.shape[0], lanes, max_blocks)
            assert 1 <= nb <= max_blocks
            rows = N.grid_partials_plain(per_slot, lanes, nb)
            assert rows.shape == (nb, 5)
            assert torch.equal(N.finalize_plain(rows), per_slot.sum(dim=0))
    assert N.grid_blocks(0) == 1
    assert N.grid_blocks(10 ** 6) == N.MAX_BLOCKS


def _lattice_case(seed, n, dims=(6, 5, 4), q=4, leaf=0.5):
    """Source and target points on a 1/8 m lattice over the window and a
    step beyond it, so that many source points have several equally near
    targets: in one cell's slots, across cells and lanes, and on every
    window face. T is a translation by binary fractions, exact in float32.
    Some cells hold more than q targets (the rest are dropped)."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(dims) * leaf
    lo, hi = -1, np.round(ext * 8).astype(int) + 1
    tgt = rng.integers(lo, hi, (400, 3)) / 8.0
    src = rng.integers(lo, hi, (max(n, 1), 3))[:n] / 8.0
    t = np.array([0.125, -0.0625, 0.25])
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    mask = np.ones(n, bool)
    mask[::11] = False
    src = np.where(mask[:, None], src - t, 1e8).astype(np.float32)
    f = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt)  # noqa
    origin = torch.zeros(3)
    slots, _ = build_terms_raster(f(src.reshape(n, 3)), f(mask, torch.bool),
                                  f(T), origin, leaf, dims, q)
    tslots, _ = build_terms_raster(f(tgt), torch.ones(len(tgt),
                                                      dtype=torch.bool),
                                   torch.eye(4), origin, leaf, dims, q)
    return (slots, raster_to_slots(tslots, dims, q), f(T), 0.3, 0.1, dims,
            q, q)


def _icp_cases(n, q):
    edge = chip_smoke.icp_edge_case("cpu", seed=n, q=q)
    return [_lattice_case(n, n, q=q),
            (_first(edge[0], n),) + edge[1:]]


@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("q", [3, 4])
@pytest.mark.parametrize("lanes", LANES)
def test_icp_lane_scan_picks_the_plain_target(lanes, q, n):
    # at Qt = 4, 4 lanes is the kernel's one lane a target slot; any other
    # pairing deals candidates out across cells
    for args in _icp_cases(n, q):
        slots, table, T, corr, delta, dims, qs, qt = args
        _, best, bq, row = I.icp_match_plain(slots, table, T, dims, qt)
        _, best2, bq2, row2 = I.lane_scan_plain(slots, table, T, dims, qt,
                                                lanes)
        # the same target for every slot, so the same d2 and point
        assert torch.equal(row, row2)
        assert torch.equal(best, best2)
        for a, b in zip(bq, bq2):
            assert torch.equal(a, b)
        ref = I.icp_terms_plain(*args)
        maxd2, hd = I._gate_constants(corr, delta)
        scale = I._totals(I._channels(slots.valid, *I.icp_match_plain(
            slots, table, T, dims, qt)[:3], maxd2, hd).abs().sum(dim=0))
        for max_blocks in (I.MAX_BLOCKS, 2):
            got = I.icp_terms_model(*args, lanes=lanes,
                                    max_blocks=max_blocks)
            assert float(got[3]) == float(ref[3])
            _close(got, ref, scale, chip_smoke.icp_blocks)


def test_lattice_case_has_ties_across_lanes_and_cells():
    # the tie case is what the merge's (d2, k) rule is for: count slots
    # whose minimum d2 is reached by two candidates in different cells
    args = _lattice_case(7, 1000)
    slots, table, T, _, _, dims, _, qt = args
    p = N._transform(slots, T)
    d2 = torch.cat([d for d, _, _ in I._candidates(slots, table, p, dims,
                                                   qt)], dim=1)
    best = d2.min(dim=1, keepdim=True).values
    at_min = (d2 == best) & (best < I.BIG)
    cells = at_min.view(-1, 27, qt).any(dim=2).sum(dim=1)
    assert int((cells > 1).sum()) > 20
    assert int((at_min.sum(dim=1) > 1).sum()) > 40
    # and slots in cells on the window's faces
    c = slots.cell[slots.valid].long()
    wx, wy, wz = dims
    on_face = ((c // (wy * wz) == 0) | (c // (wy * wz) == wx - 1)
               | ((c // wz) % wy == 0) | (c % wz == wz - 1))
    assert int(on_face.sum()) > 100
