"""The live SLAM path's compiled programs: their sync-free bodies against
their eager forms (CPU), bit for bit.

On the CPU ``compiled=True`` runs the body the card captures into a CUDA
graph, eagerly; ``compiled=False`` runs the eager form. Held here, with
every read back to the host made to raise inside the body: the batched
``icp`` (point-to-point and point-to-plane, a pair that converges early
and one that runs to ``max_iterations``, one pair and batches of 1 and 3;
the eager form stops when no pair is active, the body runs every trip);
``insert_cloud`` (an incremental insert, the full merge, and inserts that
overflow the map or the new-key bound into the full merge, whose flag is
read after the body); the keyframe store (at k = 0, at k > 0 and across a
window slide; the normals' eigh runs after the body); the scan line
(``ScanAggregator.add_staged_line``, the line's transform inside, against
the live chain's eager ``base_from_laser`` + ``add_line``: lines, an
emit, capacity overflow, a disarmed state). Nothing here runs JAX: the
reference parity of each module is in its own test file, which runs
these bodies too (the default). The CUDA graphs themselves are held in
``test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.ingest import aggregator as agg_mod
from tpu_slam_torch.ingest.frames import FrameChain, SensorModel
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import voxel_map as vm
from tpu_slam_torch.pipeline import slam as slam_mod
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.registration.icp import ICPParams, icp
from tpu_slam_torch.registration.icp import _icp_body
from tpu_slam_torch.utils.capture import signature, tensors_of


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_host_reads():
    """Make every read of a tensor's value back to the host raise."""
    def boom(*a, **k):
        raise AssertionError("a value was read back to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                     "__float__"):
            mp.setattr(torch.Tensor, name, boom)
        yield


def _same(a, b):
    """Every tensor of two results or states equal, bit for bit."""
    assert signature(a) == signature(b)
    ta, tb = tensors_of(a), tensors_of(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the batched icp
# ---------------------------------------------------------------------------

ICP_ITERS = 4


def _room(rng, n):
    """n points on a floor and two walls (every axis constrained), with
    each point's plane normal."""
    k = rng.integers(0, 3, n)
    u, v = rng.uniform(-2.0, 2.0, (2, n))
    pts = np.stack([np.where(k == 1, -2.0, u), np.where(k == 2, -2.0, v),
                    np.where(k == 0, -1.0, 0.7 * u + 0.3 * v)], axis=1)
    nrm = np.eye(3)[np.array([2, 0, 1])[k]]
    return pts.astype(np.float32), nrm.astype(np.float32)


@pytest.fixture(scope="module")
def icp_pairs():
    """Two (source, target, normals, init) pairs: the first converges in
    a few iterations, the second (a larger offset, a noisy source) is
    still moving at ICP_ITERS."""
    rng = np.random.default_rng(3)
    out = []
    for xi, noise in ((0.02, 0.0), (0.25, 0.02)):
        tgt, nrm = _room(rng, 320)
        T = se3.exp(torch.tensor([xi, -xi, 0.5 * xi, 0.1 * xi, -0.1 * xi,
                                  0.6 * xi]))
        src = (tgt[:300] - T[:3, 3].numpy()) @ T[:3, :3].numpy()
        src = src + rng.normal(0, noise, src.shape).astype(np.float32)
        mask = np.ones(320, bool)
        mask[300:] = False
        src = np.concatenate([src, np.zeros((20, 3))]).astype(np.float32)
        out.append((PointCloud(torch.from_numpy(src), torch.from_numpy(mask)),
                    PointCloud(torch.from_numpy(tgt),
                               torch.ones(320, dtype=torch.bool)),
                    torch.from_numpy(nrm), torch.eye(4)))
    return out


def _batch(pairs, idx):
    def stack(f):
        return torch.stack([f(pairs[i]) for i in idx])

    return (PointCloud(stack(lambda p: p[0].points),
                       stack(lambda p: p[0].mask)),
            PointCloud(stack(lambda p: p[1].points),
                       stack(lambda p: p[1].mask)),
            stack(lambda p: p[2]), stack(lambda p: p[3]))


@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("shape", ["pair", "batch1", "batch3"])
def test_sync_free_icp_matches_host_exit(icp_pairs, plane, shape):
    params = ICPParams(max_iterations=ICP_ITERS, tolerance=1e-5,
                       max_corr_dist=1.0, huber_delta=0.3,
                       point_to_plane=plane)
    cases = {"pair": [icp_pairs[0], icp_pairs[1]],
             "batch1": [_batch(icp_pairs, [0]), _batch(icp_pairs, [1])],
             "batch3": [_batch(icp_pairs, [0, 1, 0])]}[shape]
    iters = []
    for src, tgt, nrm, T0 in cases:
        nrm = nrm if plane else None
        eager = icp(src, tgt, init_T=T0, params=params, target_normals=nrm,
                    compiled=False)
        with _no_host_reads():
            body = _icp_body(src, tgt, T0, nrm, params, sync_free=True)
        _same(eager, body)
        _same(eager, icp(src, tgt, init_T=T0, params=params,
                         target_normals=nrm))
        iters += eager.iterations.reshape(-1).tolist()
    # one pair stopped early (the eager loop exited before the cap), the
    # other ran to the cap
    assert min(iters) < ICP_ITERS and max(iters) == ICP_ITERS


# ---------------------------------------------------------------------------
# insert_cloud
# ---------------------------------------------------------------------------

SPEC = VoxelGridSpec.centered(leaf=0.25, half_extent=16.0)


def _lattice(n, offset, rng):
    """n points, one to a 0.25 m voxel from ``offset`` on, jittered."""
    i = np.arange(n)
    cells = np.stack([i % 40, (i // 40) % 40, i // 1600], axis=1)
    pts = (cells + 0.5) * 0.25 + offset
    return (pts + rng.uniform(-0.1, 0.1, pts.shape)).astype(np.float32)


def _cloud(pts, capacity):
    out = np.full((capacity, 3), PAD_COORD, np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(capacity, bool)
    mask[:len(pts)] = True
    return PointCloud(torch.from_numpy(out), torch.from_numpy(mask))


INSERT_CASES = {
    # (map capacity, points in the map, points of the scan, scan offset)
    "incremental": (4096, 600, 700, 0.125),
    "full_merge": (4096, 600, 700, 0.125),
    "overflow_map": (1024, 600, 1000, 3.0),
    "overflow_new_keys": (16384, 100, vm.NEW_CAP + 200, 0.0),
}


@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_sync_free_insert_matches_eager(case):
    cap, n_map, n_scan, off = INSERT_CASES[case]
    rng = np.random.default_rng(1)
    base = vm.insert_cloud(vm.empty_map(cap, device="cpu"),
                           _cloud(_lattice(n_map, -5.0, rng), n_map), SPEC,
                           stamp=1.0, compiled=False)
    scan = _cloud(np.concatenate([_lattice(n_scan // 2, -5.0, rng),
                                  _lattice(n_scan - n_scan // 2, off, rng)]),
                  n_scan + 16)
    incremental = case != "full_merge"
    counts = []
    outs = []
    for compiled in (False, True):
        vm.insert_cloud.fallbacks = vm.insert_cloud.incremental = 0
        outs.append(vm.insert_cloud(base, scan, SPEC, stamp=2.0,
                                    incremental=incremental,
                                    compiled=compiled))
        counts.append((vm.insert_cloud.fallbacks,
                       vm.insert_cloud.incremental))
    _same(outs[0], outs[1])
    assert counts[0] == counts[1]
    overflow = case.startswith("overflow")
    if incremental:
        assert counts[0] == ((1, 0) if overflow else (0, 1))
    with _no_host_reads():
        body = vm._insert_program(base, scan, torch.full((), 2.0), SPEC,
                                  incremental)
    if incremental:
        merged, flag, stats = body
        assert bool(flag) == overflow
        if not overflow:
            _same(outs[0], merged)
        else:
            _same(outs[0], vm.insert_scan_stats(base, *stats, 2.0))
    else:
        _same(outs[0], body)
    assert int(outs[0].n_occupied()) > n_map


# ---------------------------------------------------------------------------
# the keyframe store
# ---------------------------------------------------------------------------

def _slam(compiled, kf_cap=4):
    cfg = SLAMConfig(
        odometry=OdometryConfig(scan_capacity=256, map_capacity=1024),
        keyframe_capacity=kf_cap, keyframe_cloud_capacity=96,
        edge_capacity=64)
    return slam_mod.SLAMSystem(cfg, device="cpu", compiled=compiled)


@pytest.mark.parametrize("stores", [1, 3, 6])
def test_sync_free_keyframe_store_matches_eager(stores):
    """k = 0 (no edge), k > 0, and the fifth store sliding the window of
    four; scans alternately shorter and longer than the 96 stored rows,
    with and without intensities."""
    rng = np.random.default_rng(2)
    runs = []
    for compiled in (False, True):
        rng = np.random.default_rng(2)
        system = _slam(compiled)
        state = system.init_state()
        states = []
        for k in range(stores):
            n = 64 if k % 2 == 0 else 128
            pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
            attrs = (rng.uniform(0, 1, (n, 2)).astype(np.float32)
                     if k % 3 else None)
            scan = PointCloud.from_points_host(pts, capacity=n + 8,
                                               attrs=attrs, device="cpu")
            xi = torch.from_numpy(rng.normal(0, 0.3, 6).astype(np.float32))
            state = dataclasses.replace(
                state, odom=dataclasses.replace(state.odom,
                                                pose=se3.exp(xi)))
            state = system._store_keyframe(state, scan)
            states.append(state)
        runs.append(states)
    for a, b in zip(*runs):
        assert a.n_keyframes == b.n_keyframes
        assert a.graph.n_nodes == b.graph.n_nodes
        assert a.n_evictions == b.n_evictions
        _same((a.graph, a.kf_points, a.kf_mask, a.kf_intensity,
               a.kf_normals, a.kf_desc, a.last_kf_pose),
              (b.graph, b.kf_points, b.kf_mask, b.kf_intensity,
               b.kf_normals, b.kf_desc, b.last_kf_pose))
        assert np.array_equal(a.last_kf_pose_np, b.last_kf_pose_np)
    last = runs[0][-1]
    assert (last.n_evictions > 0) == (stores == 6)
    assert int(last.graph.edge_mask.sum()) == last.n_keyframes - 1

    # the program itself reads nothing back
    system = _slam(True)
    state = runs[0][-1]
    g = state.graph
    loop = system.config.loop
    idx = torch.tensor([min(state.n_keyframes, 3)])
    with _no_host_reads():
        out = slam_mod._store_program(
            (state.kf_points, state.kf_mask, state.kf_intensity,
             state.kf_desc),
            (g.poses, g.edge_i, g.edge_j, g.edge_T, g.edge_info,
             g.edge_mask), idx, idx, scan, state.odom.pose,
            state.last_kf_pose, plane_verify=loop.plane_verify,
            use_sc=loop.use_scan_context, sc=loop.sc,
            odom_edge_info=system.config.odom_edge_info)
    assert out[3].shape == (96, 3, 3)


# ---------------------------------------------------------------------------
# the scan line
# ---------------------------------------------------------------------------

L = 48


def _lines(n, seed, step=0.05):
    """n lines of 41 beams (padded to L): ranges with returns out of range
    and inside the exclusion box, intensities, angles stepping ``step``
    rad a line."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ang = np.linspace(-2.0, 2.0, 41)
        rng_m = rng.uniform(0.3, 6.0, 41)
        rng_m[rng.random(41) < 0.1] = 200.0
        pts = (np.stack([np.cos(ang), np.sin(ang), np.zeros(41)], 1)
               * rng_m[:, None]).astype(np.float32)
        valid = (rng_m >= 0.01) & (rng_m <= 100.0)
        out.append((pts, valid, rng.random(41).astype(np.float32),
                    k * step))
    return out


LINE_CASES = {
    # (capacity, auto_rearm, lines, request at)
    "emit": (4096, True, 90, ()),
    "overflow": (300, True, 80, ()),
    "disarmed": (4096, False, 175, (95,)),
}


@pytest.mark.parametrize("case", sorted(LINE_CASES))
def test_sync_free_line_matches_the_eager_chain(case):
    cap, rearm, n, requests = LINE_CASES[case]
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    cfg = agg_mod.AggregatorConfig(capacity=cap, line_length=L,
                                   auto_rearm=rearm)
    eager = agg_mod.ScanAggregator(cfg, device="cpu", compiled=False)
    comp = agg_mod.ScanAggregator(cfg, device="cpu")
    se, sc = eager.init_state(), comp.init_state()
    staged = np.zeros(agg_mod.staged_size(L), np.float32)
    emits, dropped = [], 0
    for k, (pts, valid, inten, angle) in enumerate(_lines(n, seed=5)):
        if k in requests:
            se, sc = eager.request(se), comp.request(sc)
        p = np.zeros((L, 3), np.float32)
        v = np.zeros(L, bool)
        i = np.zeros(L, np.float32)
        p[:41], v[:41], i[:41] = pts, valid, inten
        se = eager.add_line(se, torch.from_numpy(p), torch.from_numpy(v),
                            chain.base_from_laser(float(angle)),
                            torch.from_numpy(i))
        agg_mod.stage_line(staged, pts, valid, inten, angle)
        with _no_host_reads():
            sc = comp.add_staged_line(sc, torch.from_numpy(staged), chain)
        _same(se, sc)
        dropped = max(dropped, int(sc.dropped))
        if bool(eager.ready(se)):
            assert bool(comp.ready(sc))
            ce, se = eager.emit(se)
            cc, sc = comp.emit(sc)
            _same(ce, cc)
            emits.append((k, int(ce.mask.sum())))
    assert emits and all(m > 0 for _, m in emits)
    assert (dropped > 0) == (case == "overflow")
    if case == "disarmed":
        # disarmed after the first emit until the request re-armed it
        assert emits[0][0] < requests[0] < emits[1][0]
        assert float(comp.progress(comp.emit(sc)[1])) == -1.0
