"""The CUDA kernels (NDT terms, brute-force NN, ICP terms, the probes'
gathers) against their plain versions, on the GPU.

These tests build csrc/*.cu with nvcc and run on a CUDA device; without
one their fixture skips them. On a GPU machine (the tests' conftest
imports JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no "
                    "CPU mode; their plain versions are tested in "
                    "test_torch_ndt_terms.py, test_torch_nn_search.py, "
                    "test_torch_icp_raster.py and "
                    "test_torch_gather_probes.py)")
    return torch.device("cuda")


def _assert_close(got, ref):
    # each block of H and half of b within 1e-4 of its own largest
    # magnitude (float32 sums in another order); matched exactly equal
    import chip_smoke

    for (label, a), (_, b) in zip(chip_smoke.terms_blocks(got),
                                  chip_smoke.terms_blocks(ref)):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), label
    assert float(got[3]) == float(ref[3])


@pytest.mark.parametrize("q", [2, 4, 8])
def test_kernel_matches_plain_on_edge_case(cuda, q):
    import chip_smoke
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    args = chip_smoke.random_terms_case(cuda, q=q, seed=q)
    before = ndt_terms.launches
    got = ndt_terms(*args)
    torch.cuda.synchronize()
    assert ndt_terms.launches == before + 1
    _assert_close(got, ndt_terms_plain(*args))


def test_kernel_empty_and_mixed_devices(cuda):
    import chip_smoke
    from tpu_slam_torch.kernels.ndt_terms import TermsSlots, ndt_terms

    slots, rows, T, gamma, max_corr, dims = chip_smoke.random_terms_case(
        cuda)
    empty = TermsSlots(points=torch.zeros(0, 3, device=cuda),
                       cell=torch.zeros(0, dtype=torch.int32, device=cuda),
                       valid=torch.zeros(0, dtype=torch.bool, device=cuda),
                       inside=torch.zeros(0, dtype=torch.bool, device=cuda))
    H, b, c, m = ndt_terms(empty, rows, T, gamma, max_corr, dims)
    assert float(H.abs().sum()) == 0 and float(c) == 0 and float(m) == 0
    with pytest.raises(ValueError):
        ndt_terms(slots, rows.cpu(), T, gamma, max_corr, dims)
    # every launch is identical run to run (fixed-order reduction)
    outs = [ndt_terms(slots, rows, T, gamma, max_corr, dims)
            for _ in range(3)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


def _nn_equal(q, t):
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)

    before = nearest_neighbors.launches
    gi, g2 = nearest_neighbors(q, t, squared=True)
    torch.cuda.synchronize()
    assert nearest_neighbors.launches == before + 1
    pi, p2 = nearest_neighbors_plain(q, t, squared=True)
    # the kernel rounds each op as the plain version does: equal indices,
    # bit-equal squared distances
    assert torch.equal(gi, pi)
    assert torch.equal(g2, p2)


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_kernel_matches_plain_on_edge_case(cuda, seed):
    import chip_smoke

    q, t, _, _ = chip_smoke.nn_edge_case(cuda, seed=seed)
    _nn_equal(q, t)
    _nn_equal(q[None], t[None])


@pytest.mark.parametrize("b, n, m", [(6, 4096, 4096), (3, 257, 1025),
                                     (1, 1, 1)])
def test_nn_kernel_matches_plain_batched(cuda, b, n, m):
    g = torch.Generator(device="cpu").manual_seed(b * n + m)
    q = (torch.rand(b, n, 3, generator=g) * 20 - 10).to(cuda)
    t = (torch.rand(b, m, 3, generator=g) * 20 - 10).to(cuda)
    if m > 1:
        t[:, m // 2:] = 1e8                 # padding targets
    _nn_equal(q, t)


def _icp_equal(args, matched=True):
    # matched: whether some slot must match (None: either)
    # each block of H, half of b, err and wsum within 1e-4 of its own
    # largest magnitude; nmatch exactly equal and every slot's chosen target
    # identical (transform and d2 rounded op by op in the plain version's
    # order, lanes merged on (d2, candidate order))
    import chip_smoke
    from tpu_slam_torch.kernels.icp_terms import (icp_terms_plain,
                                                  icp_terms_raster)

    before = icp_terms_raster.launches
    got = icp_terms_raster(*args)
    torch.cuda.synchronize()
    assert icp_terms_raster.launches == before + 1
    ref = icp_terms_plain(*args)
    for (label, a), (_, b) in zip(chip_smoke.icp_blocks(got),
                                  chip_smoke.icp_blocks(ref)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            label
    assert float(got[3]) == float(ref[3])
    assert matched is None or (float(ref[3]) > 0) == matched
    assert chip_smoke.icp_choice_equal(args)


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_icp_kernel_matches_plain_on_config1_stage(cuda, stage):
    import chip_smoke

    src, tgt, _ = chip_smoke.config1_pair(cuda, 512)
    init = None
    if stage == "fine":
        init = chip_smoke.raster_register(src, tgt)[0].T
    _icp_equal(chip_smoke.config1_stage_args(src, tgt, init, stage))


@pytest.mark.parametrize("seed", [0, 1])
def test_icp_kernel_matches_plain_on_edge_case(cuda, seed):
    import chip_smoke

    _icp_equal(chip_smoke.icp_edge_case(cuda, seed=seed))


def test_icp_raster_on_the_card_matches_the_cpu(cuda):
    import chip_smoke
    from tpu_slam_torch.core.pointcloud import PointCloud

    src, tgt, _ = chip_smoke.config1_pair(cuda, 512)
    res = [chip_smoke.raster_register(s, t)[1] for s, t in (
        (src, tgt),
        (PointCloud(points=src.points.cpu(), mask=src.mask.cpu()),
         PointCloud(points=tgt.points.cpu(), mask=tgt.mask.cpu())))]
    # the same solve; sums and solves in another order on each device
    assert int(res[0].iterations) == int(res[1].iterations)
    assert float((res[0].T.cpu() - res[1].T).abs().max()) <= 1e-4
    assert abs(float(res[0].matched_fraction)
               - float(res[1].matched_fraction)) <= 2.0 / 8192


def test_gather_kernels_match_plain(cuda):
    from tpu_slam_torch.kernels import gather as G

    g = torch.Generator(device="cpu").manual_seed(0)
    table = torch.randn(1000, 16, generator=g).to(cuda)
    idx = torch.randint(-3, 1003, (5000,), generator=g,
                        dtype=torch.int32).to(cuda)
    lane = torch.randint(0, 1000, (777, 16), generator=g,
                         dtype=torch.int32).to(cuda)
    cases = ((G.gather_rows, G.gather_rows_plain, (table, idx)),
             (G.gather_rows, G.gather_rows_plain, (table, lane)),
             (G.gather_row_sum, G.gather_row_sum_plain, (table, idx)),
             (G.onehot_gather, G.onehot_gather_plain, (table, idx)),
             (G.onehot_gather, G.onehot_gather_plain, (table, idx, True)))
    for kernel, plain, args in cases:
        before = kernel.launches
        got = kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        # bit-equal, NaN rows (indices outside the table) included
        assert torch.equal(got.isnan(), plain(*args).isnan())
        assert torch.equal(torch.nan_to_num(got),
                           torch.nan_to_num(plain(*args)))


def test_nn_kernel_rejects_bad_inputs(cuda):
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    q = torch.zeros(4, 3, device=cuda)
    with pytest.raises(ValueError):
        nearest_neighbors(q, q.cpu())
    with pytest.raises(ValueError):
        nearest_neighbors(q.double(), q.double())
    idx, d = nearest_neighbors(q[:0], q)
    assert idx.shape == (0,) and d.shape == (0,)


def test_nn_kernel_split_forcing_with_boundary_ties(cuda):
    import chip_smoke
    from tpu_slam_torch.kernels.nn_search import split_plan

    q, t, _, _ = chip_smoke.nn_split_case(cuda)
    assert split_plan(1, q.shape[0], t.shape[0])[0] > 1
    _nn_equal(q, t)
    _nn_equal(q[None], t[None])


@pytest.mark.parametrize("b, n, m", [(1, 1000, 5000), (2, 513, 30000),
                                     (3, 2049, 777), (1, 1, 200000),
                                     (6, 4097, 4096)])
def test_nn_kernel_ragged_queries(cuda, b, n, m):
    g = torch.Generator(device="cpu").manual_seed(n + m)
    q = (torch.rand(b, n, 3, generator=g) * 20 - 10).to(cuda)
    t = (torch.rand(b, m, 3, generator=g) * 20 - 10).to(cuda)
    t[:, 1::97] = t[:, ::97][:, :t[:, 1::97].shape[1]]     # exact ties
    _nn_equal(q, t)


def _gather_equal(table, idx):
    from tpu_slam_torch.kernels import gather as G

    before = G.gather_rows.launches
    got = G.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert G.gather_rows.launches == before + 1
    ref = G.gather_rows_plain(table, idx)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.parametrize("cols", [16, 7, 128, 1, 36])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_rows_vector_and_scalar_paths(cuda, cols, offset):
    # offset 1: a view 4 bytes past a 16-byte boundary (the scalar path);
    # odd widths take the scalar path too
    g = torch.Generator(device="cpu").manual_seed(cols * 2 + offset)
    rows = 1001
    big = torch.randn(rows * cols + offset, generator=g).to(cuda)
    table = big[offset:].view(rows, cols)
    idx = torch.randint(-2, rows + 2, (3000,), generator=g,
                        dtype=torch.int32).to(cuda)
    lane = torch.randint(-1, rows + 1, (777, cols), generator=g,
                         dtype=torch.int32).to(cuda)
    _gather_equal(table, idx)
    _gather_equal(table, lane)


def test_kernels_on_a_side_stream(cuda):
    import chip_smoke
    from tpu_slam_torch.kernels import gather as G
    from tpu_slam_torch.kernels.icp_terms import icp_terms_raster
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)

    q, t, _, _ = chip_smoke.nn_split_case(cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    table = torch.randn(4096, 16, generator=g).to(cuda)
    idx = torch.randint(0, 4096, (32768,), generator=g,
                        dtype=torch.int32).to(cuda)
    nargs = chip_smoke.random_terms_case(cuda)
    iargs = chip_smoke.icp_edge_case(cuda)
    want = [t.clone() for t in ndt_terms(*nargs)]
    iwant = [t.clone() for t in icp_terms_raster(*iargs)]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        gi, g2 = nearest_neighbors(q, t, squared=True)
        rows = G.gather_rows(table, idx)
        terms = ndt_terms(*nargs)
        iterms = icp_terms_raster(*iargs)
    side.synchronize()
    pi, p2 = nearest_neighbors_plain(q, t, squared=True)
    assert torch.equal(gi, pi) and torch.equal(g2, p2)
    assert torch.equal(rows, G.gather_rows_plain(table, idx))
    for x, y in zip(terms + iterms, want + iwant):
        assert torch.equal(x, y)


def _first(slots, n):
    from tpu_slam_torch.kernels.ndt_terms import TermsSlots

    return TermsSlots(points=slots.points[:n].contiguous(),
                      cell=slots.cell[:n].contiguous(),
                      valid=slots.valid[:n].contiguous(),
                      inside=slots.inside[:n].contiguous())


@pytest.mark.parametrize("n", [0, 1, 257])
def test_terms_kernels_on_short_slot_lists(cuda, n):
    # no slot, one slot, and one slot past a block's 256 threads (the last
    # block's groups get a ragged share)
    import chip_smoke
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    slots, rows, T, gamma, corr, dims = chip_smoke.random_terms_case(cuda)
    args = (_first(slots, n), rows, T, gamma, corr, dims)
    _assert_close(ndt_terms(*args), ndt_terms_plain(*args))
    iargs = chip_smoke.icp_edge_case(cuda)
    _icp_equal((_first(iargs[0], n),) + iargs[1:],
               matched={0: False, 1: None, 257: True}[n])


def test_ndt_kernel_at_config2_size(cuda):
    # config 2's fine window (192, 192, 32) at Q = 4 and ~20k slots
    import chip_smoke
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    args = chip_smoke.random_terms_case(cuda, dims=(192, 192, 32), n=24000)
    _assert_close(ndt_terms(*args), ndt_terms_plain(*args))


@pytest.mark.parametrize("q", [2, 3, 4, 8])
def test_icp_kernel_lane_splits(cuda, q):
    # each lane split the library builds picks the plain version's target
    # for every slot, ties included: one lane a target slot at Qt = 2, 4 and
    # 8, candidates dealt out to 8 lanes at Qt = 3
    import chip_smoke
    from tpu_slam_torch.kernels import icp_terms as I

    args = chip_smoke.icp_edge_case(cuda, seed=q, q=q)
    slots, table, T, corr, delta, dims, _, qt = args
    row = I.icp_match_plain(slots, table, T, dims, qt)[3]
    ref = I.icp_terms_plain(*args)
    choice = torch.empty(slots.cell.shape[0], dtype=torch.int32,
                         device=cuda)
    out = I.run_kernels(slots, table, T, *I._gate_constants(corr, delta),
                        dims, qt, choice=choice)
    assert torch.equal(choice.long(), row)
    got = (out[:36].view(6, 6), out[36:42], out[42], out[43], out[44])
    assert float(got[3]) == float(ref[3]) > 0
    for (label, a), (_, b) in zip(chip_smoke.icp_blocks(got),
                                  chip_smoke.icp_blocks(ref)):
        assert float((a - b).abs().max()) <= \
            1e-4 * float(b.abs().max()), label


def test_terms_kernels_repeat_bit_for_bit(cuda):
    # fixed-order sums, no atomics: two calls on the same inputs are equal
    import chip_smoke
    from tpu_slam_torch.kernels.icp_terms import icp_terms_raster
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms

    args = chip_smoke.random_terms_case(cuda, dims=(96, 96, 32), n=20000)
    iargs = chip_smoke.icp_edge_case(cuda)
    for kernel, a in ((ndt_terms, args), (icp_terms_raster, iargs)):
        first = [t.clone() for t in kernel(*a)]
        for _ in range(3):
            for x, y in zip(kernel(*a), first):
                assert torch.equal(x, y)


def test_terms_kernels_on_two_streams(cuda):
    # two calls in flight on two side streams, each on its own inputs: each
    # gets its own result (the default stream's, bit for bit)
    import chip_smoke
    from tpu_slam_torch.kernels.icp_terms import icp_terms_raster
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms

    nargs = [chip_smoke.random_terms_case(cuda, seed=s) for s in (5, 6)]
    iargs = [chip_smoke.icp_edge_case(cuda, seed=s) for s in (2, 3)]
    want = [[t.clone() for t in ndt_terms(*a)] for a in nargs]
    iwant = [[t.clone() for t in icp_terms_raster(*a)] for a in iargs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got, igot = [], []
    for s, a, ia in zip(streams, nargs, iargs):
        with torch.cuda.stream(s):
            got.append(ndt_terms(*a))
            igot.append(icp_terms_raster(*ia))
    for s in streams:
        s.synchronize()
    for g, w in zip(got + igot, want + iwant):
        for x, y in zip(g, w):
            assert torch.equal(x, y)
