"""The port's brute-force NN against tpu_slam's (CPU).

The plain PyTorch version (what a CPU tensor runs, and the CUDA kernel's
oracle on the card) against the reference's XLA twin ``_nn_brute_xla`` and
its Pallas kernel in interpret mode, on the same seeded inputs: ties,
padding in queries and targets, sizes that are multiples of no tile, one
pair and a batch of six. Then the card's split plan: the target range cut
into ranges and merged (the merge's plain version) gives the one-pass
result exactly, ties on the split boundaries included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_slam.kernels import nn_search as jnn
from tpu_slam_torch.kernels.nn_search import (BLOCK_QUERIES, FILL_BLOCKS,
                                              MAX_SPLITS, MIN_SPLIT_TARGETS,
                                              merge_splits_plain,
                                              nearest_neighbors,
                                              nearest_neighbors_plain,
                                              plan_for_splits, split_plan,
                                              split_scan_plain)

PAD = 1e8


def _case(seed, n, m, n_pad=0, m_pad=0, dups=0):
    """Query (n, 3) and target (m, 3) at room scale; the last n_pad / m_pad
    rows are padding; ``dups`` target rows repeat earlier ones exactly and
    ``dups`` queries sit exactly on a repeated target (a tie of distance
    0 that the lowest index must win)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    q = (rng.uniform(-8, 8, (n, 3))).astype(np.float32)
    for k in range(dups):
        src = k * 3
        t[m - m_pad - 1 - k] = t[src]                 # later duplicate
        q[k] = t[src]
        q[dups + k] = t[src] + np.float32(0.05)       # near the duplicate
    if n_pad:
        q[n - n_pad:] = PAD
    if m_pad:
        t[m - m_pad:] = PAD
    return q, t


def _unambiguous(q, t, rel=1e-6):
    """Queries whose best and second-best d^2 differ by more than ``rel``
    (relative), computed in float64: only there is the index defined up
    to float32 rounding."""
    d = ((q[:, None, :].astype(np.float64) - t[None, :, :]) ** 2).sum(-1)
    if d.shape[1] == 1:
        return np.ones(len(q), bool)
    part = np.partition(d, 1, axis=1)
    return part[:, 1] - part[:, 0] > rel * np.maximum(part[:, 1], 1e-30)


def _reference(q, t):
    i, d = jnn._nn_brute_xla(jnp.asarray(q), jnp.asarray(t))
    return np.asarray(i), np.asarray(d)


CASES = [(0, 300, 700, 0, 0, 0), (1, 257, 513, 17, 40, 5),
         (2, 1000, 333, 0, 11, 8), (3, 64, 1, 0, 0, 0)]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_xla(case):
    q, t = _case(*case)
    idx, dist = nearest_neighbors_plain(torch.as_tensor(q),
                                        torch.as_tensor(t))
    ri, rd = _reference(q, t)
    valid = np.all(q < PAD / 2, axis=1)
    ok = valid & _unambiguous(q, t)
    # indices equal wherever the minimum is unambiguous; ties (exact
    # duplicates) included, since both take the lowest index
    np.testing.assert_array_equal(idx.numpy()[ok], ri[ok])
    dup = valid.copy()
    dup[case[5]:] = False
    np.testing.assert_array_equal(idx.numpy()[dup], ri[dup])
    # the same float32 ops in the same order: distances within 1e-6 m
    np.testing.assert_allclose(dist.numpy()[valid], rd[valid], atol=1e-6)
    assert idx.dtype == torch.int32


def test_ties_go_to_the_lowest_index():
    q, t = _case(4, 40, 90, dups=6)
    idx, dist = nearest_neighbors_plain(torch.as_tensor(q),
                                        torch.as_tensor(t))
    np.testing.assert_array_equal(idx.numpy()[:6], np.arange(6) * 3)
    assert float(dist[:6].abs().max()) == 0.0


def test_plain_matches_pallas_interpret():
    q, t = _case(5, 300, 700, 20, 30, 4)
    with pltpu.force_tpu_interpret_mode():
        pi, pd = jnn._nn_brute_pallas(jnp.asarray(q), jnp.asarray(t))
    idx, dist = nearest_neighbors_plain(torch.as_tensor(q),
                                        torch.as_tensor(t))
    valid = np.all(q < PAD / 2, axis=1)
    ok = valid & _unambiguous(q, t)
    np.testing.assert_array_equal(idx.numpy()[ok], np.asarray(pi)[ok])
    np.testing.assert_allclose(dist.numpy()[valid], np.asarray(pd)[valid],
                               atol=1e-6)


@pytest.mark.parametrize("b", [1, 6])
def test_batched_equals_per_pair(b):
    pairs = [_case(10 + k, 200 + 13 * k, 350 - 7 * k, 9, 12, 3)
             for k in range(b)]
    n = min(len(p[0]) for p in pairs)
    m = min(len(p[1]) for p in pairs)
    q = np.stack([p[0][:n] for p in pairs])
    t = np.stack([p[1][:m] for p in pairs])
    idx, dist = nearest_neighbors_plain(torch.as_tensor(q),
                                        torch.as_tensor(t))
    assert idx.shape == (b, n) and dist.shape == (b, n)
    for k in range(b):
        i1, d1 = nearest_neighbors_plain(torch.as_tensor(q[k]),
                                         torch.as_tensor(t[k]))
        assert torch.equal(idx[k], i1) and torch.equal(dist[k], d1)
        ri, rd = _reference(q[k], t[k])
        valid = np.all(q[k] < PAD / 2, axis=1)
        ok = valid & _unambiguous(q[k], t[k])
        np.testing.assert_array_equal(i1.numpy()[ok], ri[ok])


def test_squared_and_padding_never_wins():
    q, t = _case(6, 50, 80, 0, 30)
    i2, d2 = nearest_neighbors_plain(torch.as_tensor(q), torch.as_tensor(t),
                                     squared=True)
    i1, d1 = nearest_neighbors_plain(torch.as_tensor(q), torch.as_tensor(t))
    assert torch.equal(i1, i2)
    assert torch.equal(torch.sqrt(torch.clamp(d2, min=0.0)), d1)
    assert int(i1.max()) < 50                          # a padding target never


def test_wrapper_dispatches_cpu_to_plain_and_rejects_bad_inputs():
    q, t = _case(7, 30, 40)
    qt, tt = torch.as_tensor(q), torch.as_tensor(t)
    k0, p0 = nearest_neighbors.launches, nearest_neighbors_plain.launches
    a = nearest_neighbors(qt, tt)
    b = nearest_neighbors_plain(qt, tt)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert nearest_neighbors.launches == k0             # no kernel on CPU
    assert nearest_neighbors_plain.launches == p0 + 2
    with pytest.raises(ValueError):
        nearest_neighbors(qt.double(), tt.double())
    with pytest.raises(ValueError):
        nearest_neighbors(qt[None], tt)
    with pytest.raises(ValueError):
        nearest_neighbors(qt, tt[:0])
    with pytest.raises(ValueError):
        nearest_neighbors(qt.to("meta"), tt.to("meta"))


# The card's split plan: the target range cut into ranges that separate
# blocks scan, each keeping its minimum and the 32-target group that holds
# it, then merged in ascending order with a strict '<' and the index found
# in the winning group. Emulated here with the two kernels' plain versions.

def _split_then_merge(q, t, splits, chunk):
    d2, group = split_scan_plain(q, t, splits, chunk)
    return merge_splits_plain(d2, group, q, t, chunk)


def _boundary_ties(seed, b, n, m, chunk, splits):
    """b pairs with exact duplicate targets on both sides of every split
    boundary (t[c*chunk] = t[c*chunk - 1]) and across splits (t[c*chunk +
    1] = t[1]), queries exactly on them and 0.01 m off them, and padding
    targets at the end."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-8, 8, (b, m, 3)).astype(np.float32)
    q = rng.uniform(-8, 8, (b, n, 3)).astype(np.float32)
    k = 0
    for c in range(1, splits):
        lo = c * chunk
        t[:, lo] = t[:, lo - 1]
        if lo + 1 < m:
            t[:, lo + 1] = t[:, 1]
        for src in (lo - 1, 1):
            if k + 1 < n:
                q[:, k] = t[:, src]
                q[:, k + 1] = t[:, src] + np.float32(0.01)
                k += 2
    t[:, m - 3:] = PAD
    return torch.as_tensor(q), torch.as_tensor(t)


@pytest.mark.parametrize("want", range(1, 9))
def test_split_and_merge_equal_one_pass_with_boundary_ties(want):
    m = 1000 + 37 * want
    splits, chunk = plan_for_splits(m, want)
    assert 1 <= splits <= want and (splits - 1) * chunk < m <= splits * chunk
    q, t = _boundary_ties(want, 2, 90, m, chunk, splits)
    gi, g2 = _split_then_merge(q, t, splits, chunk)
    pi, p2 = nearest_neighbors_plain(q, t, squared=True)
    assert torch.equal(gi, pi) and torch.equal(g2, p2)
    if splits > 1:
        # a query on a tie across the first boundary keeps the lower index
        assert int(gi[0, 0]) == chunk - 1 and float(g2[0, 0]) == 0.0


@pytest.mark.parametrize("b, n, m", [
    (1, 8192, 8192), (6, 4096, 4096), (1, 65536, 65536),
    (1, 131072, 131072), (1, 300, 200000), (1, 1, 1), (3, 257, 1025),
    (2, 1, 100)])
def test_split_plan(b, n, m):
    splits, chunk = split_plan(b, n, m)
    # every split holds at least one target, and together they hold all
    assert 1 <= splits <= MAX_SPLITS
    assert (splits - 1) * chunk < m <= splits * chunk
    query_blocks = -(-n // BLOCK_QUERIES) * b
    if splits > 1:
        assert chunk >= MIN_SPLIT_TARGETS
        assert query_blocks * (splits - 1) < FILL_BLOCKS
    elif m >= 2 * MIN_SPLIT_TARGETS:
        assert query_blocks >= FILL_BLOCKS
    # the plan is the same for the same sizes
    assert split_plan(b, n, m) == (splits, chunk)


def test_merge_plain_keeps_the_earliest_split_and_lowest_index_on_ties():
    # one query at the origin; targets at d^2 1 in groups of splits 0 and
    # 2 and twice in split 1 (one chunk of 64 = two groups a split); split
    # 1 has a nearer target (d^2 0.25) twice, the second in a later group
    t = torch.full((1, 192, 3), 5.0)
    for k in (3, 70, 100, 150):
        t[0, k] = torch.tensor([1.0, 0.0, 0.0])
    t[0, 90] = t[0, 120] = torch.tensor([0.0, 0.5, 0.0])
    q = torch.zeros(1, 1, 3)
    d2, group = split_scan_plain(q, t, 3, 64)
    assert d2[:, 0, 0].tolist() == [1.0, 0.25, 1.0]
    assert group[:, 0, 0].tolist() == [0, 64, 128]
    i, d = merge_splits_plain(d2, group, q, t, 64)
    assert int(i) == 90 and float(d) == 0.25
    t[0, 90] = t[0, 120] = 5.0                  # now ties of d^2 1 only
    i, d = merge_splits_plain(*split_scan_plain(q, t, 3, 64), q, t, 64)
    assert int(i) == 3 and float(d) == 1.0
