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


def _bits_equal(got, ref):
    """Bit-equal, the sign of zero included; NaN where the other is NaN."""
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.view(torch.int32)[~nan],
                       ref.view(torch.int32)[~nan])


def _gather_call(fn, table, idx):
    """The wrapper and its plain version for one of the gather cases, with
    their arguments: gather_rows on row or per-element indices, the row
    sum, the one-hot in float32 or bfloat16."""
    from tpu_slam_torch.kernels import gather as G

    rows, cols = table.shape
    if fn == "gather_rows_per_element":
        g = torch.Generator(device="cpu").manual_seed(idx.numel() + cols)
        lane = torch.randint(-1, rows + 1, (idx.shape[0], cols), generator=g,
                             dtype=torch.int32).to(idx.device)
        return G.gather_rows, G.gather_rows_plain, (table, lane)
    if fn == "onehot_gather_bf16":
        return G.onehot_gather, G.onehot_gather_plain, (table, idx, True)
    return getattr(G, fn), getattr(G, fn + "_plain"), (table, idx)


# (cols, table offset in floats): the float4 path at 4, 16, 128 and 256
# columns (lanes walk several units at 256); the scalar path on a table 4
# bytes off 16-byte alignment (16, 200) and at an odd width
GATHER_SHAPES = [(4, 0), (16, 0), (128, 0), (256, 0), (16, 1), (200, 1),
                 (7, 0)]


@pytest.mark.parametrize("fn", ["gather_rows", "gather_rows_per_element",
                                "gather_row_sum", "onehot_gather",
                                "onehot_gather_bf16"])
@pytest.mark.parametrize("cols, offset", GATHER_SHAPES)
@pytest.mark.parametrize("m", [1, 4999])
def test_gather_kernels_match_plain(cuda, fn, cols, offset, m):
    # m = 4999 fills no block's last row slot; indices outside the table
    # give NaN rows (rows, row sum) and zero rows (one-hot)
    g = torch.Generator(device="cpu").manual_seed(cols * 7 + offset + m)
    rows = 1000
    big = torch.randn(rows * cols + offset, generator=g).to(cuda)
    table = big[offset:].view(rows, cols)
    idx = torch.randint(-3, rows + 3, (m,), generator=g,
                        dtype=torch.int32).to(cuda)
    if m > 1:
        idx[:2] = torch.tensor([-1, rows], dtype=torch.int32)
    kernel, plain, args = _gather_call(fn, table, idx)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _bits_equal(got, plain(*args))


@pytest.mark.parametrize("cols, offset", [(16, 0), (16, 1), (7, 0)])
def test_onehot_bf16_ties_and_non_finite_values(cuda, cols, offset):
    # bfloat16 ties (to even, both ways), FLT_MAX (rounds to inf), a
    # subnormal tie, -0.0, +-inf and NaN, on both paths
    from tpu_slam_torch.kernels import gather as G

    special = torch.tensor([0x3F808000, 0x3F818000, -0x407F8000, 0x7F7FFFFF,
                            0x00008000, -0x80000000, 0x7F800000, -0x00800000,
                            0x7FC00000], dtype=torch.int32).view(torch.float32)
    g = torch.Generator(device="cpu").manual_seed(cols + offset)
    rows = 64
    host = torch.randn(rows * cols + offset, generator=g)
    flat = host[offset:]
    flat[:special.numel()] = special[:flat.numel()]
    flat[5 * cols:5 * cols + 3] = special[-3:]
    table = host.to(cuda)[offset:].view(rows, cols)
    idx = torch.randint(-2, rows + 2, (777,), generator=g,
                        dtype=torch.int32).to(cuda)
    idx[:4] = torch.tensor([0, 1, 5, -1], dtype=torch.int32)
    for bf16 in (True, False):
        before = G.onehot_gather.launches
        got = G.onehot_gather(table, idx, bf16)
        torch.cuda.synchronize()
        assert G.onehot_gather.launches == before + 1
        _bits_equal(got, G.onehot_gather_plain(table, idx, bf16))
    assert torch.isinf(got[2, :2]).all() and got[3].eq(0).all()


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


@pytest.mark.parametrize("dims, q, n", [((160, 160, 32), 4, 18600),
                                        ((64, 64, 16), 4, 3000),
                                        ((64, 64, 16), 8, 6000)])
def test_ndt_kernel_at_config3_shapes(cuda, dims, q, n):
    # config 3's fine window (160, 160, 32) at ~18.6k points, and its
    # coarse / far window (64, 64, 16)
    import chip_smoke
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    args = chip_smoke.random_terms_case(cuda, dims=dims, q=q, n=n, seed=q)
    _assert_close(ndt_terms(*args), ndt_terms_plain(*args))


def test_occupancy_update_repeats_bit_for_bit_and_matches_the_cpu(cuda):
    # equal-value marks: the same layer, rows and count on every call and
    # on either device
    import numpy as np

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.mapping import dense_map as dm

    rng = np.random.default_rng(0)
    dims, oc = (64, 64, 16), (96, 96, 120)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=64.0)
    g = 64 * 64 * 16
    rows = np.zeros((g, 10), np.float32)
    on = rng.uniform(size=g) < 0.3
    rows[on, 0] = 3.0
    lo = rng.uniform(-1.3, 0.3, (g, 1)).astype(np.float32)
    origin = np.array([0.3, -0.2, 1.5], np.float32)
    pts = (origin + rng.normal(0, 8.0, (30000, 3))).astype(np.float32)

    def run(dev):
        grid = dm.DenseMomentGrid(rows=torch.tensor(rows, device=dev),
                                  origin_cell=torch.tensor(
                                      oc, dtype=torch.int32, device=dev),
                                  dims=dims)
        occ = dm.DenseMomentGrid(rows=torch.tensor(lo, device=dev),
                                 origin_cell=grid.origin_cell, dims=dims)
        cloud = PointCloud.from_points_host(pts, 32768, device=dev)
        return dm.grid_occupancy_update(grid, occ,
                                        torch.tensor(origin, device=dev),
                                        cloud, spec)

    first = run(cuda)
    for _ in range(2):
        again = run(cuda)
        assert torch.equal(again[0].rows, first[0].rows)
        assert torch.equal(again[1].rows, first[1].rows)
        assert int(again[2]) == int(first[2]) > 0
    ref = run("cpu")
    # the sample lattice is the same float32 arithmetic on both devices;
    # a cell may differ only where a sample lies within an ulp of a face
    differ = int((ref[1].rows != first[1].rows.cpu()).sum())
    assert differ <= 1e-4 * g


def test_aggregator_on_the_card_equals_the_cpu(cuda):
    """ScanAggregator.add_line on the card against the same stream on the
    CPU, line by line: masks, write_idx, dropped and the emitting line
    exact (a 2,000-slot capacity that overflows inside each scan, points
    inside the exclusion box); points within 1e-5 m (the card's matmul
    rounds in another order); the sweep of each within the float32 bound
    a line of the exact sum of the steps (test_torch_aggregator.py: the
    arccos of a near-1 dot product turns its last bit into ~2e-5 rad at a
    0.05 rad step)."""
    import math

    import numpy as np

    from tpu_slam_torch.ingest.aggregator import (AggregatorConfig,
                                                  ScanAggregator)
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

    rng = np.random.default_rng(0)
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    cfg = AggregatorConfig(capacity=2000, line_length=64)
    aggs = [ScanAggregator(cfg, device=d) for d in ("cpu", cuda)]
    states = [a.init_state() for a in aggs]
    emits = [[], []]
    bound = 4 * 2.0 ** -23 / math.sin(0.05 / 2) + 1e-6
    n_inc, latched = 0, False       # steps summed since the latching line
    for k in range(160):
        p = torch.from_numpy(rng.uniform(-4, 4, (64, 3)).astype(np.float32))
        v = torch.from_numpy(rng.random(64) < 0.8)
        i = torch.from_numpy(rng.random(64).astype(np.float32))
        for n, (a, d) in enumerate(zip(aggs, ("cpu", cuda))):
            states[n] = a.add_line(states[n], p.to(d), v.to(d),
                                   chain.base_from_laser(k * 0.05, device=d),
                                   i.to(d))
        cpu, card = states
        assert int(card.write_idx) == int(cpu.write_idx)
        assert int(card.dropped) == int(cpu.dropped)
        assert torch.equal(card.mask[:2000].cpu(), cpu.mask[:2000])
        assert (card.points[:2000].cpu() - cpu.points[:2000]).abs().max() \
            <= 1e-5
        n_inc, latched = (n_inc + 1 if latched else 0), True
        for st in (card, cpu):
            assert abs(float(st.angular_distance) - 0.05 * n_inc) \
                <= n_inc * bound
        for n, a in enumerate(aggs):
            if bool(a.ready(states[n])):
                emits[n].append(k)
                _, states[n] = a.emit(states[n])
                n_inc, latched = 0, False
    n = math.ceil(1.1 * math.pi / 0.05)
    assert emits[0] == emits[1] == [n, 2 * n + 1]


def test_overlap_cost_on_the_card(cuda):
    """overlap_cost at the truth of chip_smoke's calibration capture (the
    reference test's room, at a quarter of the segments) on the card and
    on the CPU: the counts within 0.5 %, below the cost at zero."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.ingest.calibration import CalibConfig, overlap_cost

    true = np.asarray(chip_smoke.CALIB_TRUE, np.float32)
    data = chip_smoke.calibration_capture(cuda, segments=180)
    cpu = chip_smoke.calibration_capture("cpu", segments=180)
    cfg = CalibConfig()
    got = int(overlap_cost(data, true, cfg))
    ref = int(overlap_cost(cpu, true, cfg))
    assert abs(got - ref) <= 0.005 * ref
    assert got < int(overlap_cost(data, np.zeros(5, np.float32), cfg))


def test_collectives_on_the_card_through_nccl(cuda):
    """World size 1 on NCCL through distributed.mesh: the collectives run
    on device memory (no host staging), a shift with no peer gives zeros."""
    import numpy as np

    # tests/ is on the path (pytest's rootdir insertion); a site package
    # may own the name "tests" on the machine with the card
    import test_torch_dist_ranks as R
    from tpu_slam_torch.distributed import mesh as M

    (got,) = M.run_ranks(R.nccl_body, 1, backend="nccl", device="cuda")
    x = np.arange(12, dtype=np.float32)
    for name in ("all_reduce", "reduce_scatter", "all_gather"):
        np.testing.assert_array_equal(got[name], x)
    np.testing.assert_array_equal(got["shift"], np.zeros(12, np.float32))
    np.testing.assert_array_equal(got["halo_left"], np.zeros(2, np.float32))
    assert got["device"].startswith("cuda") and got["backend"] == "nccl"
    assert got["stats"]["staged_copies"] == 0


def _office_case(device, n=5):
    """A small dense-engine config and the office's first n scans."""
    import numpy as np

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.registration.ndt import NDTParams

    def cfg(**kw):
        return OdometryConfig(
            scan_capacity=4096, downsample_leaf=0.2, map_leaf=0.4,
            map_half_extent=16.0, scan_max_range=12.0,
            insert_downsampled=True,
            ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                          tolerance=3e-4, min_voxel_count=3.0,
                          window_dims=(32, 32, 16)),
            pyramid_factor=2, rebase_fraction=0.05, **kw)

    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(n):
        T = syn.se2_pose(0.3 * k - 0.6, 0.12 * k - 0.3, 0.07 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=600, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=12288,
                                                  device=device))
        gt.append(T)
    return cfg, clouds, np.stack(gt)


@pytest.mark.parametrize("options", [False, True])
def test_captured_step_matches_eager_step(cuda, options):
    """DenseLidarOdometry's captured step against compiled=False on the
    card: every state bit for bit; the sync-free body warms up with
    synchronising calls made errors."""
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam_torch.utils.capture import Captured

    cfg, clouds, gt = _office_case(cuda)
    kw = dict(deskew=True, use_occupancy=True) if options else {}
    warm = DenseLidarOdometry(cfg(**kw))
    state = warm.init_state(clouds[0], gt[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm._step_impl(state, clouds[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    runs = []
    for compiled in (False, True):
        eng = DenseLidarOdometry(cfg(**kw), compiled=compiled)
        state = eng.init_state(clouds[0], gt[0])
        states = []
        for c in clouds[1:]:
            state = eng.step(state, c)
            states.append(state)
        runs.append((states, eng))
    (eager, _), (captured, eng) = runs
    assert len(eng.graphs) == 1
    cap = next(iter(eng.graphs.values())).graph
    assert isinstance(cap, Captured) and cap.replays == len(clouds) - 1
    assert cap.calls["ndt_terms"] > 0
    for a, b in zip(eager, captured):
        for f in ("pose", "last_delta", "scan_index", "last_metrics"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for g in ("grid", "wide", "occ"):
            ga, gb = getattr(a, g), getattr(b, g)
            if ga is not None:
                assert torch.equal(ga.rows, gb.rows), g
                assert torch.equal(ga.origin_cell, gb.origin_cell), g
    assert not torch.equal(eager[0].grid.origin_cell,
                           eager[-1].grid.origin_cell)
    if options:
        assert int(runs[0][1].n_evicted) == int(eng.n_evicted)


def test_stage_marks_in_the_captured_step(cuda):
    """The dense step's stage marks (csrc/span_mark.cu) inside its graph:
    with enable() the recorder keeps each replay's slots and reads each
    step's stage times at flush; under the profiler every mark kernel
    shows by its stage's name; the LM counters count in the graph."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam_torch.registration.ndt import lm_trips
    from tpu_slam_torch.utils import tracing

    cfg, clouds, gt = _office_case(cuda)
    eng = DenseLidarOdometry(cfg())
    state = eng.init_state(clouds[0], gt[0])
    state = eng.step(state, clouds[1])          # the capture
    with tracing.enable():
        for c in clouds[2:4]:
            state = eng.step(state, c)
        counts = tracing.counters()
        steps = tracing.flush_marks()
    assert len(steps) == 2 and tracing.flush_marks() == []
    for by in steps:
        assert set(by) == {"prep", "map", "field", "raster", "solve"}
        assert all(0 < v < 1.0 for v in by.values())
    trips = lm_trips(eng.config.ndt) + lm_trips(eng.coarse_params)
    assert counts["ndt_lm_iters_run"] == 2 * trips
    assert 0 < counts["ndt_lm_iters_used"] <= 2 * trips
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step(state, clouds[4])
        torch.cuda.synchronize()
    marks = [e.name() for e in prof.profiler.kineto_results.events()
             if "span_mark<stage_" in e.name()]
    assert {m[m.index("<stage_") + 7:m.index(">")] for m in marks} == set(
        tracing.STAGES)


def test_captured_pose_graph_solve_matches_eager(cuda):
    """optimize_pose_graph's captured PCG solve against the eager one on a
    noisy chain with loops: poses and chi^2 bit for bit, under annealing
    (one fixed-work graph a robust width) and a short last CG chunk."""
    import numpy as np

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.graph import pose_graph as pg

    rng = np.random.default_rng(1)
    n = 40
    g = pg.empty_graph(48, 96, device=cuda)
    T = torch.eye(4, device=cuda)
    for _ in range(n):
        step = torch.tensor(rng.normal(0, [0.3, 0.05, 0.01, 0.005, 0.005,
                                           0.05]), dtype=torch.float32,
                            device=cuda)
        T = se3.exp(step) @ T
        g, _ = pg.add_node(g, T)
    for i in range(1, n):
        noise = torch.tensor(rng.normal(0, 0.01, 6), dtype=torch.float32,
                             device=cuda)
        g = pg.add_edge(g, i - 1, i, se3.exp(noise) @ se3.inverse(
            g.poses[i - 1]) @ g.poses[i])
    for i, j in ((0, 30), (5, 38), (12, 25)):
        g = pg.add_edge(g, i, j, se3.inverse(g.poses[i]) @ g.poses[j],
                        info=400.0 * torch.eye(6, device=cuda))
    for params in (pg.GraphSolveParams(gn_iterations=6, cg_iterations=50,
                                       robust_delta=0.3, robust_anneal=4.0),
                   pg.GraphSolveParams(gn_iterations=4, cg_iterations=200,
                                       robust_delta=0.3, trust_loops=True)):
        eager, chi_e = pg.optimize_pose_graph(g, params, compiled=False)
        for _ in range(2):
            got, chi = pg.optimize_pose_graph(g, params)
            assert torch.equal(got.poses, eager.poses)
            assert torch.equal(chi, chi_e)


# ---------------------------------------------------------------------------
# The registration layer's captured programs against their eager forms
# ---------------------------------------------------------------------------

def _office_scans(device, n, capacity=8192):
    """The office's first n VLP-16 scans (300 azimuths) and their poses."""
    import numpy as np

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(n):
        T = syn.se2_pose(0.3 * k - 0.6, 0.12 * k - 0.3, 0.07 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            syn.default_office(), T, n_azimuth=300, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=capacity,
                                                  device=device))
        gt.append(T)
    return clouds, np.stack(gt).astype(np.float32)


def _host_config(path, **kw):
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.registration.ndt import NDTParams

    ndt = dict(max_iterations=8, coarse_iterations=2, tolerance=3e-4,
               min_voxel_count=3.0)
    ndt.update(dict(window_dims=(40, 40, 16)) if path == "kernel"
               else dict(terms_impl="xla"))
    return OdometryConfig(scan_capacity=2048, downsample_leaf=0.25,
                          map_leaf=0.4, map_half_extent=16.0,
                          map_capacity=16384, ndt=NDTParams(**ndt), **kw)


@pytest.mark.parametrize("case", ["kernel", "kernel_far_yaw", "sparse"])
def test_captured_register_matches_eager(cuda, case):
    """compiled_register's CUDA graph against the host-exit form: the
    result bit for bit at every replay, no read or synchronisation in a
    call (sync-debug "error")."""
    import dataclasses

    import chip_smoke
    from tpu_slam_torch.core import se3
    from tpu_slam_torch.kernels.downsample import voxel_downsample
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.mapping.voxel_map import (coarse_spec_of,
                                                  coarsen_map, empty_map,
                                                  insert_cloud)
    from tpu_slam_torch.registration import ndt

    clouds, gt = _office_scans(cuda, 2)
    spec = VoxelGridSpec.centered(leaf=0.4, half_extent=16.0)
    T0, T1 = (torch.as_tensor(g, device=cuda) for g in gt)
    vmap = insert_cloud(empty_map(16384, device=cuda), clouds[0].transform(T0),
                        spec)
    scan = voxel_downsample(clouds[1], VoxelGridSpec.centered(
        leaf=0.2, half_extent=16.0), capacity=2048)
    params = _host_config("sparse" if case == "sparse" else "kernel").ndt
    kw = {}
    if case == "kernel_far_yaw":
        params = dataclasses.replace(params, window_dims=(12, 12, 8),
                                     yaw_candidates=5)
        cspec = coarse_spec_of(spec, 2)
        kw = dict(far_field=ndt.ndt_field(coarsen_map(vmap, spec, 2), cspec,
                                          params, center=T1[:3, 3]),
                  far_spec=cspec)
    field = ndt.ndt_field(vmap, spec, params, center=T1[:3, 3])
    init = se3.exp(torch.tensor([0.15, -0.1, 0.03, 0.0, 0.0, 0.06],
                                device=cuda)) @ T1
    eager = ndt.compiled_register(scan, field, spec, init_T=init,
                                  params=params, compiled=False, **kw)
    ndt.compiled_register(scan, field, spec, init_T=init, params=params,
                          **kw)                       # captures
    with chip_smoke.replays_sync_checked() as chk:
        got = [ndt.compiled_register(scan, field, spec, init_T=init,
                                     params=params, **kw) for _ in range(2)]
    assert chk.calls == 2 and eager.iterations > 0
    for g in got:
        assert chip_smoke.ndt_results_equal(eager, g)


@pytest.mark.parametrize("path", ["kernel", "sparse"])
def test_captured_host_engine_matches_eager(cuda, path):
    """LidarOdometry's captured registrations (the coarse, then the fine
    one on the kernel path) and map inserts against compiled=False over
    four scans."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.mapping.voxel_map import insert_cloud
    from tpu_slam_torch.pipeline.odometry import LidarOdometry

    clouds, gt = _office_scans(cuda, 4)
    cfg = _host_config(path, pyramid_factor=2 if path == "kernel" else 0)
    runs = []
    for compiled in (False, True):
        eng = LidarOdometry(cfg, compiled=compiled)
        eng.warm_up(clouds[0])
        insert_cloud.fallbacks = insert_cloud.incremental = 0
        with chip_smoke.replays_sync_checked() as chk:
            poses, log = eng.run(clouds, init_pose=gt[0])
        runs.append((poses, [(m.iterations, m.matched_fraction)
                             for m in log.records], chk.calls,
                     insert_cloud.fallbacks + insert_cloud.incremental,
                     eng.field_builds))
    (p0, m0, c0, i0, _), (p1, m1, c1, i1, builds) = runs
    assert np.array_equal(p0, p1) and m0 == m1 and i0 == i1 > 1
    # the warm-up captured every graph the run replayed: the
    # registrations of each tracked scan, every insert and, with the
    # pyramid, coarsen_map at every field build
    assert c0 == 0 and c1 == ((len(clouds) - 1) * (2 if path == "kernel"
                                                   else 1) + i1
                              + (builds if path == "kernel" else 0))


def test_captured_jit_step_matches_eager(cuda):
    """JitLidarOdometry's whole step as one CUDA graph against the
    host-exit step: every state tensor bit for bit, no read inside."""
    import chip_smoke
    from tpu_slam_torch.pipeline.odometry_jit import JitLidarOdometry

    clouds, gt = _office_scans(cuda, 4)
    runs = []
    for compiled in (False, True):
        eng = JitLidarOdometry(_host_config("kernel"), compiled=compiled)
        state = eng.init_state(clouds[0], gt[0])
        states = []
        with chip_smoke.replays_sync_checked() as chk:
            for c in clouds[1:]:
                state = eng.step(state, c)
                states.append(state)
        runs.append((states, chk.calls, len(eng.graphs)))
    (e, _, _), (c, calls, graphs) = runs
    assert calls == len(clouds) - 1 and graphs == 1
    assert all(chip_smoke.same_tensors(a, b) for a, b in zip(e, c))
    assert float(e[-1].last_metrics[3]) == 1.0        # inserted


def test_captured_icp_raster_matches_eager(cuda):
    """Config 1's raster tier at 8k (coarse, then fine call) captured
    against the host-exit form, bit for bit, no read inside a call."""
    import chip_smoke

    src, tgt, xi = chip_smoke.config1_pair(cuda, 512)
    eager = chip_smoke.raster_register(src, tgt, compiled=False)
    chip_smoke.raster_register(src, tgt)              # captures
    with chip_smoke.replays_sync_checked() as chk:
        got = chip_smoke.raster_register(src, tgt)
    assert chk.calls == 2
    assert all(chip_smoke.same_tensors(a, b) for a, b in zip(eager, got))
    assert chip_smoke.recovery_err_mm(xi, got[1].T) <= \
        chip_smoke.C1_RASTER_BAR_MM


def test_dense_reanchor_compiled_matches_eager(cuda):
    """The dense SLAM with the default re-anchor and map rebuild through
    its loops on the captured step and on compiled=False: every pose and
    every key of the final state bit for bit."""
    import chip_smoke

    row = chip_smoke.dense_reanchor_compare()
    assert row["reanchors"] > 0 and row["loops"] > 0
    assert row["poses_bit_equal"] and not row["state_keys_differing"]
    # one captured step, and one graph for each window's rebuild, replayed
    # at every re-anchor
    assert row["captured_steps"] == 1
    assert row["grid_rebuild"]["replays"] == [row["reanchors"]] * 2


# ---------------------------------------------------------------------------
# The live SLAM path's captured programs against their eager forms
# ---------------------------------------------------------------------------

def _room_pair(device, xi, noise, seed, n=4096):
    """A cloud on a floor and two walls, and the same cloud moved by
    exp(xi)^-1 with noise: (source, target, target normals)."""
    import numpy as np

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud

    rng = np.random.default_rng(seed)
    k = rng.integers(0, 3, n)
    u, v = rng.uniform(-4.0, 4.0, (2, n))
    tgt = np.stack([np.where(k == 1, -4.0, u), np.where(k == 2, -4.0, v),
                    np.where(k == 0, -1.5, 0.5 * u + 0.2 * v)], axis=1)
    nrm = np.eye(3)[np.array([2, 0, 1])[k]]
    T = se3.exp(torch.tensor(xi)).numpy()
    src = (tgt - T[:3, 3]) @ T[:3, :3] + rng.normal(0, noise, tgt.shape)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(device)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    return (PointCloud(t(src), mask),
            PointCloud(t(tgt), torch.ones_like(mask)), t(nrm))


@pytest.mark.parametrize("plane", [False, True])
def test_captured_icp_matches_eager(cuda, plane):
    """The batched icp's CUDA graph (3 pairs: one converging early, the
    others running to the cap) and one pair's, against the host-exit
    form: every result bit for bit at each replay, no read or
    synchronisation in a call, the NN kernel launched every trip."""
    import chip_smoke
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors
    from tpu_slam_torch.registration.icp import ICPParams, icp

    pairs = [_room_pair(cuda, [0.01, 0, 0, 0, 0, 0.005], 0.0, 0),
             _room_pair(cuda, [0.2, -0.1, 0.05, 0.02, 0.0, 0.1], 0.01, 1),
             _room_pair(cuda, [-0.3, 0.2, 0.0, 0.0, 0.03, -0.1], 0.02, 2)]
    batch = [type(pairs[0][0])(torch.stack([p[i].points for p in pairs]),
                               torch.stack([p[i].mask for p in pairs]))
             for i in (0, 1)] + [torch.stack([p[2] for p in pairs])]
    params = ICPParams(max_iterations=12, tolerance=1e-5,
                       point_to_plane=plane)
    for src, tgt, nrm in (batch, pairs[1]):
        nrm = nrm if plane else None
        eager = icp(src, tgt, params=params, target_normals=nrm,
                    compiled=False)
        icp(src, tgt, params=params, target_normals=nrm)      # captures
        before = chip_smoke.launches_of(nearest_neighbors)
        with chip_smoke.replays_sync_checked() as chk:
            got = [icp(src, tgt, params=params, target_normals=nrm)
                   for _ in range(2)]
        assert chk.calls == 2
        assert chip_smoke.launches_of(nearest_neighbors) - before == 24
        for g in got:
            assert chip_smoke.same_tensors(eager, g)


@pytest.mark.parametrize("case", ["incremental", "overflow", "full"])
def test_captured_insert_matches_eager(cuda, case):
    """insert_cloud's graph (the scan's stats and the merge; the overflow
    flag read after it) against compiled=False: the map bit for bit and
    the same fallback counts, no synchronisation inside a call."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.mapping import voxel_map as vm

    rng = np.random.default_rng(0)
    spec = VoxelGridSpec.centered(leaf=0.25, half_extent=16.0)
    pts = rng.uniform(-6, 6, (20000, 3)).astype(np.float32)
    base = vm.insert_cloud(vm.empty_map(16384 if case != "overflow"
                                        else 9000, device=cuda),
                           PointCloud.from_points_host(pts[:8000], 8192,
                                                       device=cuda),
                           spec, stamp=1.0)
    scan = PointCloud.from_points_host(pts[4000:10000], 6144, device=cuda)
    incremental = case != "full"
    outs, counts = [], []
    for compiled in (False, True, True, True):
        vm.insert_cloud.fallbacks = vm.insert_cloud.incremental = 0
        with chip_smoke.replays_sync_checked() as chk:
            outs.append(vm.insert_cloud(base, scan, spec, stamp=2.0,
                                        incremental=incremental,
                                        compiled=compiled))
        counts.append((vm.insert_cloud.fallbacks,
                       vm.insert_cloud.incremental, chk.calls))
    for o in outs[1:]:
        assert chip_smoke.same_tensors(outs[0], o)
    assert counts[0][:2] == counts[1][:2] and counts[3][2] == 1
    if incremental:
        assert counts[0][:2] == ((1, 0) if case == "overflow" else (0, 1))


def test_captured_keyframe_store_matches_eager(cuda):
    """The keyframe store's graph (k and e device scalars: one capture for
    every keyframe) against compiled=False over six stores of a window of
    four (k = 0, k > 0, a slide): every buffer bit for bit, the normals'
    eigh after the replay, no synchronisation inside a call."""
    import dataclasses

    import numpy as np

    import chip_smoke
    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.pipeline import slam as slam_mod
    from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    cfg = SLAMConfig(
        odometry=OdometryConfig(scan_capacity=2048, map_capacity=4096),
        keyframe_capacity=4, keyframe_cloud_capacity=1024, edge_capacity=64)
    runs = []
    n_graphs = len(slam_mod._stores)
    for compiled in (False, True):
        rng = np.random.default_rng(2)
        system = slam_mod.SLAMSystem(cfg, device=cuda, compiled=compiled)
        state = system.init_state()
        states = []
        with chip_smoke.replays_sync_checked() as chk:
            for k in range(6):
                n = 700 if k % 2 == 0 else 1500
                scan = PointCloud.from_points_host(
                    rng.uniform(-8, 8, (n, 3)).astype(np.float32),
                    capacity=n + 16, device=cuda,
                    attrs=rng.uniform(0, 1, (n, 1)).astype(np.float32))
                xi = torch.from_numpy(
                    rng.normal(0, 0.3, 6).astype(np.float32)).to(cuda)
                state = dataclasses.replace(
                    state, odom=dataclasses.replace(state.odom,
                                                    pose=se3.exp(xi)))
                state = system._store_keyframe(state, scan)
                states.append(slam_state_to_numpy(state))
        runs.append((states, chk.calls))
    (eager, _), (captured, calls) = runs
    # one graph for each of the two scan sizes
    assert calls == 6 and len(slam_mod._stores) == n_graphs + 2
    for a, b in zip(eager, captured):
        assert sorted(a) == sorted(b)
        for key in a:
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key


def _agg_equal(a, b, capacity):
    """Two aggregator states equal bit for bit, but for the spare row past
    the capacity (the dropped writes land there in any order)."""
    import dataclasses

    import chip_smoke

    def cut(s):
        return dataclasses.replace(s, points=s.points[:capacity],
                                   intensity=s.intensity[:capacity],
                                   mask=s.mask[:capacity])

    return chip_smoke.same_tensors(cut(a), cut(b))


def test_captured_line_matches_eager_while_another_thread_runs(cuda):
    """The scan line's graph, captured while a second thread keeps
    launching work on the device, against the eager chain (the live
    pipeline's base_from_laser + add_line): every state bit for bit over
    lines that fill the capacity, an emit, the next scan started; no
    synchronisation inside a line's call."""
    import threading

    import numpy as np

    import chip_smoke
    from tpu_slam_torch.ingest import aggregator as agg_mod
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    L = 1024
    cfg = agg_mod.AggregatorConfig(capacity=20000, line_length=L)
    eager = agg_mod.ScanAggregator(cfg, device=cuda, compiled=False)
    comp = agg_mod.ScanAggregator(cfg, device=cuda)
    stop = threading.Event()

    def busy():
        x = torch.ones(1 << 20, device=cuda)
        while not stop.is_set():
            x.mul_(1.0000001)
        torch.cuda.synchronize()

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        se, sc = eager.init_state(), comp.init_state()
        staged = torch.zeros(agg_mod.staged_size(L), pin_memory=True)
        rng = np.random.default_rng(7)
        emits = dropped = 0
        with chip_smoke.replays_sync_checked() as chk:
            for k in range(160):
                ang = np.linspace(-2.3, 2.3, 541)
                r = rng.uniform(0.3, 8.0, 541)
                pts = (np.stack([np.cos(ang), np.sin(ang), np.zeros(541)], 1)
                       * r[:, None]).astype(np.float32)
                valid = r < 7.5
                inten = rng.random(541).astype(np.float32)
                p = np.zeros((L, 3), np.float32)
                v = np.zeros(L, bool)
                i = np.zeros(L, np.float32)
                p[:541], v[:541], i[:541] = pts, valid, inten
                se = eager.add_line(
                    se, torch.from_numpy(p).to(cuda),
                    torch.from_numpy(v).to(cuda),
                    chain.base_from_laser(k * 0.05, device=cuda),
                    torch.from_numpy(i).to(cuda))
                agg_mod.stage_line(staged.numpy(), pts, valid, inten,
                                   k * 0.05)
                sc = comp.add_staged_line(
                    sc, staged.to(cuda, non_blocking=True), chain)
                # (the comparison's reads free the staging buffer)
                assert _agg_equal(se, sc, cfg.capacity)
                dropped = max(dropped, int(sc.dropped))
                if bool(eager.ready(se)):
                    assert bool(comp.ready(sc))
                    ce, se = eager.emit(se)
                    cc, sc = comp.emit(sc)
                    assert chip_smoke.same_tensors(ce, cc)
                    emits += 1
    finally:
        stop.set()
        worker.join()
    assert emits == 2 and chk.calls == 160 and len(comp._lines) == 1
    assert dropped > 0


# ---------------------------------------------------------------------------
# The default SLAM's loop sweep and the host engine's options
# ---------------------------------------------------------------------------

def _keyframe_buffers(device, K=8, P=2048, live=6, seed=5):
    """K keyframe slots of P room points at random poses, the first
    ``live`` filled: (poses (K, 4, 4), points (K, P, 3), mask (K, P))."""
    import numpy as np

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PAD_COORD

    rng = np.random.default_rng(seed)
    pts = np.full((K, P, 3), PAD_COORD, np.float32)
    mask = np.zeros((K, P), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(live):
        m = P - 200 * k
        c = rng.integers(0, 3, m)
        u, v = rng.uniform(-6.0, 6.0, (2, m))
        pts[k, :m] = np.stack([np.where(c == 1, -6.0, u),
                               np.where(c == 2, -6.0, v),
                               np.where(c == 0, -1.5, 0.4 * u - 0.2 * v)], 1)
        mask[k, :m] = True
        poses[k] = se3.exp(torch.from_numpy(
            rng.normal(0, 0.3, 6).astype(np.float32))).numpy()
    return tuple(torch.from_numpy(x).to(device) for x in (poses, pts, mask))


@pytest.mark.parametrize("capacity", [16384, 1024])
def test_captured_map_rebuild_matches_eager(cuda, capacity):
    """The map rebuild's graph (the flatten, the empty map and the
    insert's body; n a device scalar) against compiled=False at two values
    of n: the map bit for bit, one capture for both, no read or
    synchronisation inside; at capacity 1024 the voxels overflow, and the
    full merge runs after the replay."""
    import chip_smoke
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.mapping.voxel_map import insert_cloud
    from tpu_slam_torch.pipeline import slam as slam_mod

    poses, pts, mask = _keyframe_buffers(cuda)
    spec = VoxelGridSpec.centered(leaf=0.25, half_extent=16.0)
    n_graphs = len(slam_mod._map_rebuilds)
    for n in (3, 6):
        runs = []
        for compiled in (False, True):
            counts = (insert_cloud.fallbacks, insert_cloud.incremental)
            with chip_smoke.replays_sync_checked() as chk:
                vmap = slam_mod._rebuild_map_batched(
                    poses, pts, mask, n, spec=spec, capacity=capacity,
                    compiled=compiled)
            runs.append((vmap, chk.calls,
                         (insert_cloud.fallbacks - counts[0],
                          insert_cloud.incremental - counts[1])))
        (e, _, ce), (c, calls, cc) = runs
        assert chip_smoke.same_tensors(e, c) and calls == 1
        assert ce == cc == ((1, 0) if capacity == 1024 else (0, 1))
        occ = c.occupied_mask()
        assert set(c.stamp[occ].tolist()) == {float(n)}
    assert len(slam_mod._map_rebuilds) == n_graphs + 1


@pytest.mark.parametrize("align", [1, 4])
def test_captured_grid_rebuild_matches_eager(cuda, align):
    """A dense window's rebuild graph (n and the centre its inputs)
    against compiled=False at two values of n and two centres, one near
    the grid's edge: rows and origin bit for bit, one capture for all."""
    import chip_smoke
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.pipeline import slam as slam_mod

    poses, pts, mask = _keyframe_buffers(cuda)
    spec = VoxelGridSpec.centered(leaf=0.25, half_extent=16.0)
    n_graphs = len(slam_mod._grid_rebuilds)
    for n, center in ((3, [0.4, -0.2, 0.1]), (6, [15.6, -15.7, 0.3])):
        center = torch.tensor(center, device=cuda)
        e = slam_mod._rebuild_grid_batched(
            poses, pts, mask, n, center, spec=spec, dims=(64, 64, 16),
            align=align, compiled=False)
        with chip_smoke.replays_sync_checked() as chk:
            c = slam_mod._rebuild_grid_batched(
                poses, pts, mask, n, center, spec=spec, dims=(64, 64, 16),
                align=align)
        assert chip_smoke.same_tensors(e, c) and chk.calls == 1
        assert float(c.rows[:, 0].sum()) > 0
    assert len(slam_mod._grid_rebuilds) == n_graphs + 1


def test_captured_sc_distance_matches_eager(cuda):
    """sc_distance's graph over a (12, 16, 60) database with empty slots
    against the eager score, for two queries: the distances bit for bit,
    the same candidates, one capture."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.graph import scan_context as sc

    _, pts, mask = _keyframe_buffers(cuda)
    db = torch.zeros((12, 16, 60), device=cuda)
    for k in range(8):
        db[k] = sc.scan_context(PointCloud(pts[k], mask[k]))
    n_graphs = len(sc._distances)
    for q in (5, 7):
        e = sc.sc_distances(db[q], db, compiled=False)
        with chip_smoke.replays_sync_checked() as chk:
            c = sc.sc_distances(db[q], db)
        assert torch.equal(e, c) and chk.calls == 1
        for a, b in zip(sc.propose_sc_candidates(db[q], db, q, 8, 1.0, 2, 3,
                                                 compiled=False),
                        sc.propose_sc_candidates(db[q], db, q, 8, 1.0, 2,
                                                 3)):
            np.testing.assert_array_equal(a, b)
    assert len(sc._distances) == n_graphs + 1


def test_captured_host_options_match_eager(cuda):
    """LidarOdometry with the pyramid, occupancy and deskew on, warmed up,
    against compiled=False over four scans: poses, metrics, map and grid
    bit for bit; coarsen_map, occupancy_maintain and deskew_cloud each one
    graph captured by the warm-up and replayed in the run, no read or
    synchronisation inside."""
    import dataclasses

    import numpy as np

    import chip_smoke
    from tpu_slam_torch.pipeline import odometry as odo_mod

    clouds, gt = _office_scans(cuda, 4)
    cfg = _host_config("kernel", pyramid_factor=2, use_occupancy=True,
                       occupancy_capacity=16384, occupancy_steps=32,
                       occupancy_max_range=15.0, deskew=True)
    caches = (odo_mod._coarsens, odo_mod._maintains, odo_mod._deskews)
    runs = []
    for compiled in (False, True):
        eng = odo_mod.LidarOdometry(cfg, compiled=compiled)
        eng.warm_up(clouds[0])
        before = [chip_smoke.cache_replays(c) for c in caches]
        with chip_smoke.replays_sync_checked() as chk:
            poses, state, _ = chip_smoke.run_host(eng, clouds, gt[0])
        use = [chip_smoke.cache_use(c, b) for c, b in zip(caches, before)]
        runs.append((poses, [dataclasses.replace(m, wall_time_s=0.0)
                             for m in eng.metrics.records], state,
                     chk.calls, use))
    (p0, m0, s0, c0, _), (p1, m1, s1, c1, use) = runs
    assert np.array_equal(p0, p1) and m0 == m1
    assert chip_smoke.same_tensors((s0.vmap, s0.occ), (s1.vmap, s1.occ))
    assert c0 == 0 and c1 > 0
    for u in use:
        assert u["captured"] == 0 and len(u["replays"]) == 1


# ---------------------------------------------------------------------------
# The reference's last compiled programs: the calibration's cost and
# gradient step, the Schur solve, the sharded dense step, the ray caster
# ---------------------------------------------------------------------------

def test_captured_overlap_cost_matches_eager(cuda):
    """overlap_cost's graph on chip_smoke's calibration capture (a quarter
    of its segments) at six vectors against the eager count, bit for bit,
    no read or synchronisation inside a call, one capture; a 20-evaluation
    twiddle takes the eager form's path."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.ingest import calibration as cal

    data = chip_smoke.calibration_capture(cuda, segments=180)
    cfg = cal.CalibConfig()
    rng = np.random.default_rng(0)
    vecs = [np.asarray(chip_smoke.CALIB_TRUE, np.float32),
            np.zeros(5, np.float32)] + [
        rng.normal(0, 0.02, 5).astype(np.float32) for _ in range(4)]
    before = chip_smoke.cache_replays(cal._costs)
    with chip_smoke.replays_sync_checked() as chk:
        got = [cal.overlap_cost(data, v, cfg) for v in vecs]
    want = [cal.overlap_cost(data, v, cfg, compiled=False) for v in vecs]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    use = chip_smoke.cache_use(cal._costs, before)
    assert chk.calls == len(vecs) and use["replays"] == [len(vecs)]
    assert use["captured"] <= 1     # an earlier test may hold the graph
    tw = [cal.calibrate_twiddle(data, cfg, max_evaluations=20, compiled=c)
          for c in (True, False)]
    assert np.array_equal(tw[0].params5, tw[1].params5)
    assert tw[0].history == tw[1].history
    assert tw[0].evaluations == tw[1].evaluations


def test_captured_gradient_step_matches_eager(cuda):
    """Five gradient steps as one CapturedStep (forward, autograd.grad,
    Adam in place, the history slot) against the eager body: history,
    parameters and final count bit for bit; two eager solves repeat bit
    for bit (the backward's gather sums in a fixed order); one capture,
    every replay free of reads."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.ingest import calibration as cal

    data = chip_smoke.calibration_capture(cuda, segments=180)
    cfg = cal.CalibConfig()
    eager = [cal.calibrate_gradient(data, cfg, steps=5, compiled=False)
             for _ in range(2)]
    before = chip_smoke.cache_replays(cal._grad_steps)
    with chip_smoke.replays_sync_checked() as chk:
        got = cal.calibrate_gradient(data, cfg, steps=5)
    for e in eager:
        assert np.array_equal(got.params5, e.params5)
        assert got.history == e.history and got.cost == e.cost
    use = chip_smoke.cache_use(cal._grad_steps, before)
    assert use["captured"] == 1 and use["replays"] == [5]
    assert chk.calls == 5 + 1           # the steps and the final count


def test_captured_schur_matches_eager(cuda):
    """The single-process Schur solve (annealed robust widths, loops) as
    one graph against compiled=False, in float32 and float64: poses and
    chi^2 bit for bit at two replays, chi^2 on the card, one capture a
    (structure, dtype), no read inside a replay."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.distributed import schur
    from tpu_slam_torch.graph.pose_graph import GraphSolveParams
    from test_torch_compiled_rest import _circle_graph

    g32 = _circle_graph()
    params = GraphSolveParams(gn_iterations=6, solver="dense",
                              robust_delta=2.0, robust_kernel="cauchy",
                              robust_anneal=4.0)
    for dtype in (torch.float32, torch.float64):
        g = chip_smoke._graph_torch(chip_smoke._graph_numpy(g32), cuda,
                                    str(dtype).split(".")[1])
        eager, chi_e = schur.optimize_pose_graph_schur(None, g, params,
                                                       compiled=False)
        before = chip_smoke.cache_replays(schur._solves)
        with chip_smoke.replays_sync_checked() as chk:
            runs = [schur.optimize_pose_graph_schur(None, g, params)
                    for _ in range(2)]
        for got, chi in runs:
            assert torch.equal(got.poses, eager.poses)
            assert torch.equal(chi, chi_e) and chi.device.type == "cuda"
        use = chip_smoke.cache_use(schur._solves, before)
        assert use["captured"] == 1 and use["replays"] == [2]
        assert chk.calls == 2
        assert np.isfinite(float(chi_e))


def test_captured_dense_solve_matches_eager(cuda):
    """optimize_pose_graph's dense solver (annealed robust widths, loops)
    as one graph against compiled=False, in float32 and float64: poses and
    chi^2 bit for bit at two replays, chi^2 on the card, one capture a
    (signature, params), no read inside a replay; the graph with one node
    and edge more at the same capacities replays that capture, bit-equal
    to its own eager solve."""
    import chip_smoke
    from tpu_slam_torch.core import se3
    from tpu_slam_torch.graph import pose_graph as pg
    from test_torch_compiled_rest import _circle_graph

    g32 = _circle_graph()
    bigger32, k = pg.add_node(g32, g32.poses[g32.n_nodes - 1])
    bigger32 = pg.add_edge(bigger32, k - 1, k, se3.exp(torch.tensor(
        [0.5, 0.0, 0.0, 0.0, 0.0, 0.1])))
    params = pg.GraphSolveParams(gn_iterations=6, solver="dense",
                                 robust_delta=2.0, robust_kernel="cauchy",
                                 robust_anneal=4.0)
    for dtype in ("float32", "float64"):
        g, bigger = (chip_smoke._graph_torch(chip_smoke._graph_numpy(x),
                                             cuda, dtype)
                     for x in (g32, bigger32))
        for graph, solves, captured in ((g, 2, 1), (bigger, 1, 0)):
            eager, chi_e = pg.optimize_pose_graph(graph, params,
                                                  compiled=False)
            before = chip_smoke.cache_replays(pg._dense_solves)
            with chip_smoke.replays_sync_checked() as chk:
                runs = [pg.optimize_pose_graph(graph, params)
                        for _ in range(solves)]
            for got, chi in runs:
                assert torch.equal(got.poses, eager.poses)
                assert torch.equal(chi, chi_e) and chi.device.type == "cuda"
            use = chip_smoke.cache_use(pg._dense_solves, before)
            assert use["captured"] == captured
            assert use["replays"] == [solves] and chk.calls == solves
            assert bool(torch.isfinite(chi_e))


def test_captured_sharded_step_and_schur_on_nccl(cuda):
    """World size 1 on NCCL: the sharded dense step (two scans) and the
    Schur solve captured with their collectives, against compiled=False on
    the same rank: rows, pose, delta, metrics, poses and chi^2 bit for
    bit, no read inside a replay, one capture each."""
    import numpy as np

    import chip_smoke
    import test_torch_dist_ranks as R
    from tpu_slam_torch.distributed import mesh as M
    from tpu_slam_torch.graph.pose_graph import GraphSolveParams
    from test_torch_compiled_rest import DIMS, _circle_graph, _dense_case

    case = _dense_case()
    scans = [(s.points.numpy(), s.mask.numpy()) for s in case["scans"]]
    graph = chip_smoke._graph_numpy(_circle_graph())
    (got,) = M.run_ranks(R.compiled_body, 1, case["rows"].numpy(),
                         case["oc"].numpy(), case["pose"].numpy(), scans,
                         case["spec"], DIMS, case["params"], graph,
                         GraphSolveParams(gn_iterations=4, solver="dense"),
                         backend="nccl", device="cuda")
    e, c = got["eager"], got["captured"]
    for k in ("steps", "poses", "chi2"):
        assert np.array_equal(e[k], c[k]), k
    assert e["checked"] == 0 and c["checked"] == len(scans) + 2
    assert got["captures"] == 2


def test_captured_raycast_matches_eager(cuda):
    """The ray caster's graph on chip_smoke's city scans (16 x 4096 rays
    from two poses of its route) against compiled=False: the ranges bit
    for bit, the replays free of reads, one capture for both poses."""
    import numpy as np

    import chip_smoke
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.dense_city(extent=200.0, seed=0)
    dirs = syn.vlp16_directions(4096)
    before = chip_smoke.cache_replays(syn._raycasts)
    out = {}
    for compiled in (False, True):
        out[compiled] = []
        with chip_smoke.replays_sync_checked() as chk:
            for T in chip_smoke.city_route(24)[::12]:
                d = dirs @ T[:3, :3].T
                out[compiled].append(world.raycast(
                    np.broadcast_to(T[:3, 3], d.shape), d, 75.0,
                    device=cuda, compiled=compiled))
        assert chk.calls == (2 if compiled else 0)
    for a, b in zip(out[False], out[True]):
        assert np.array_equal(a, b) and np.isfinite(a).any()
    use = chip_smoke.cache_use(syn._raycasts, before)
    assert use["captured"] <= 1 and use["replays"] == [2]
