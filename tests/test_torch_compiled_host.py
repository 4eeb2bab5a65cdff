"""The default SLAM's loop sweep and the host engine's options as compiled
programs: their sync-free bodies against their eager forms (CPU), bit for
bit.

On the CPU ``compiled=True`` runs the body the card captures into a CUDA
graph, eagerly; ``compiled=False`` runs the eager form. Held here, with
every read back to the host made to raise inside the body: the map
rebuild after a loop (``_rebuild_map_program``: n a device scalar, two
values of n on the same buffers, and an insert that overflows into the
full merge, whose flag is read after the body); the dense windows'
rebuild (``_rebuild_grid_program`` at align 1 and at the engine's factor,
the centre near the grid's edge); ``propose_sc_candidates`` (its
``sc_distance``: empty slots, the index gap, ``top_k``); and the host
engine's option programs, ``coarsen_map`` at factors 2 and 4, the
occupancy maintenance (with and without evictions) and the deskew, and a
three-scan run with all three options on. Nothing here runs JAX: each
module's parity with the reference is in its own test file, which runs
these bodies too (the default). The CUDA graphs themselves are held in
``test_torch_cuda.py``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.graph import scan_context as sc
from tpu_slam_torch.ingest.deskew import deskew_cloud, vlp16_time_fractions
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping import voxel_map as vm
from tpu_slam_torch.mapping.occupancy import empty_occupancy
from tpu_slam_torch.pipeline import odometry as odom_mod
from tpu_slam_torch.pipeline import slam as slam_mod
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.registration.ndt import NDTParams
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


def _n(k):
    return torch.full((), k, dtype=torch.int32)


SPEC = VoxelGridSpec.centered(leaf=0.25, half_extent=8.0)


def _room(rng, n):
    """n points on a floor and two walls of a 6 m room."""
    k = rng.integers(0, 3, n)
    u, v = rng.uniform(-3.0, 3.0, (2, n))
    return np.stack([np.where(k == 1, -3.0, u), np.where(k == 2, -3.0, v),
                     np.where(k == 0, -1.0, 0.5 * u + 0.2 * v)],
                    axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def keyframes():
    """Six keyframes of up to 512 room points (the last slots empty) at
    poses around the room: (poses (8, 4, 4), points, mask)."""
    rng = np.random.default_rng(5)
    K, P = 8, 512
    pts = np.full((K, P, 3), PAD_COORD, np.float32)
    mask = np.zeros((K, P), bool)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(6):
        m = 300 + 35 * k
        pts[k, :m] = _room(rng, m)
        mask[k, :m] = True
        poses[k] = se3.exp(torch.from_numpy(rng.normal(
            0, 0.2, 6).astype(np.float32))).numpy()
    return (torch.from_numpy(poses), torch.from_numpy(pts),
            torch.from_numpy(mask))


# ---------------------------------------------------------------------------
# the after-loop rebuilds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [4096, 512])
def test_map_rebuild_body_matches_eager(keyframes, capacity):
    """Two values of n on the same buffers: one signature (n is a device
    scalar, not a key), every stamp n, the map bit for bit; at capacity
    512 the keyframes' voxels overflow the map, and the full merge runs
    after the body, as the eager insert's does."""
    poses, pts, mask = keyframes
    sigs = set()
    for n in (3, 6):
        counts = (vm.insert_cloud.fallbacks, vm.insert_cloud.incremental)
        eager = slam_mod._rebuild_map_batched(
            poses, pts, mask, n, spec=SPEC, capacity=capacity,
            compiled=False)
        eager_counts = (vm.insert_cloud.fallbacks - counts[0],
                        vm.insert_cloud.incremental - counts[1])
        args = (poses, pts, mask, _n(n))
        sigs.add(signature(args))
        with _no_host_reads():
            merged, overflow, stats = slam_mod._rebuild_map_program(
                *args, spec=SPEC, capacity=capacity)
        assert bool(overflow) == (capacity == 512)
        assert eager_counts == ((1, 0) if capacity == 512 else (0, 1))
        body = vm.settle_insert(None, merged, overflow, stats, _n(n))
        _same(eager, body)
        _same(eager, slam_mod._rebuild_map_batched(
            poses, pts, mask, n, spec=SPEC, capacity=capacity))
        occ = body.occupied_mask()
        assert int(occ.sum()) > 0
        assert set(body.stamp[occ].tolist()) == {float(n)}
    assert len(sigs) == 1


@pytest.mark.parametrize("align", [1, 4])
def test_grid_rebuild_body_matches_eager(keyframes, align):
    """The window rebuild at align 1 (the wide window) and at the engine's
    factor, its centre near the grid's edge (the window clipped into the
    grid): rows and origin bit for bit at two values of n."""
    poses, pts, mask = keyframes
    dims = (32, 32, 8)
    center = torch.tensor([7.6, -7.7, 0.3])
    for n in (2, 6):
        eager = slam_mod._rebuild_grid_batched(
            poses, pts, mask, n, center, spec=SPEC, dims=dims, align=align,
            compiled=False)
        with _no_host_reads():
            body = slam_mod._rebuild_grid_program(
                poses, pts, mask, _n(n), center, spec=SPEC, dims=dims,
                align=align)
        _same(eager, body)
        _same(eager, slam_mod._rebuild_grid_batched(
            poses, pts, mask, n, center, spec=SPEC, dims=dims, align=align))
        oc = eager.origin_cell.tolist()
        assert oc[0] == SPEC.cells_per_axis - dims[0] and oc[1] == 0
        assert float(eager.rows[:, 0].sum()) > 0


# ---------------------------------------------------------------------------
# the scan-context score
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def descriptors(keyframes):
    """A (12, 16, 60) database: 8 descriptors of the keyframes (two of
    them empty), then 4 empty slots."""
    _, pts, mask = keyframes
    db = torch.zeros((12, 16, 60))
    for k in range(8):
        db[k] = sc.scan_context(PointCloud(pts[k], mask[k]))
    return db


@pytest.mark.parametrize("q, n, gap, dmax, top_k", [
    (7, 8, 3, 1.0, 3),            # empty slots past n, the gap
    (5, 6, 1, 1.0, 2),            # a short gap, top_k cuts
    (5, 6, 2, 0.05, 3),           # the distance bound cuts
    (2, 8, 3, 1.0, 3)])           # inside the gap: none
def test_sc_candidates_body_matches_eager(descriptors, q, n, gap, dmax,
                                         top_k):
    db = descriptors
    with _no_host_reads():
        d = sc.sc_distances(db[q], db)
    assert torch.equal(d, sc.sc_distance(db[q], db))
    eager = sc.propose_sc_candidates(db[q], db, q, n, dmax, gap, top_k,
                                     compiled=False)
    got = sc.propose_sc_candidates(db[q], db, q, n, dmax, gap, top_k)
    for a, b in zip(eager, got):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and len(a) <= top_k
    assert all(i < n and i <= q - gap - 1 for i in got[0])
    if q >= gap + 1 and dmax >= 1.0:
        assert len(got[0]) == min(top_k, q - gap)


# ---------------------------------------------------------------------------
# the host engine's option programs
# ---------------------------------------------------------------------------

def _engine(compiled, **kw):
    cfg = OdometryConfig(
        scan_capacity=1024, downsample_leaf=0.25, map_leaf=0.25,
        map_half_extent=8.0, map_capacity=4096, occupancy_capacity=8192,
        occupancy_steps=24, occupancy_max_range=10.0,
        ndt=NDTParams(max_iterations=4, coarse_iterations=2,
                      tolerance=3e-4, min_voxel_count=3.0,
                      window_dims=(32, 32, 16)), **kw)
    return odom_mod.LidarOdometry(cfg, device="cpu", compiled=compiled)


def _room_map(rng, n=3000):
    return vm.insert_cloud(vm.empty_map(4096, device="cpu"),
                           PointCloud.from_points_host(_room(rng, n), 3072,
                                                       device="cpu"),
                           SPEC, stamp=1.0)


@pytest.mark.parametrize("factor", [2, 4])
def test_coarsen_body_matches_eager(factor):
    vmap = _room_map(np.random.default_rng(factor))
    eng = _engine(True, pyramid_factor=factor)
    with _no_host_reads():
        body = eng._coarsen(vmap)
    eager = _engine(False, pyramid_factor=factor)._coarsen(vmap)
    _same(eager, body)
    _same(eager, vm.coarsen_map(vmap, SPEC, factor))
    assert 0 < int(body.occupied_mask().sum()) < int(
        vmap.occupied_mask().sum())


@pytest.mark.parametrize("evict", [True, False])
def test_occupancy_body_matches_eager(evict):
    """A scan from the room's centre against a map holding an object
    between the sensor and the walls: with a threshold above one scan's
    miss odds the object's voxels are seen through and evicted, with the
    default (-1.0) none is."""
    rng = np.random.default_rng(7)
    room = _room(rng, 2000)
    blob = rng.normal([1.5, 0.0, 0.0], 0.1, (200, 3)).astype(np.float32)
    vmap = vm.insert_cloud(
        vm.empty_map(4096, device="cpu"),
        PointCloud.from_points_host(np.concatenate([room, blob]), 2304,
                                    device="cpu"), SPEC, stamp=1.0)
    # the scan: the walls along the rays through the object
    scan = PointCloud.from_points_host(room, 2048, device="cpu")
    T = se3.exp(torch.tensor([0.05, -0.02, 0.0, 0.0, 0.0, 0.03]))
    kw = dict(use_occupancy=True,
              occupancy_evict_below=-0.3 if evict else -1.0)
    eng = _engine(True, **kw)
    occ = empty_occupancy(8192, device="cpu")
    eager = _engine(False, **kw)._maintain_occupancy(occ, vmap, T, scan)
    with _no_host_reads():
        body = eng._maintain_occupancy(occ, vmap, T, scan)
    _same(eager, body)
    n_ev = int(body[2])
    assert (n_ev > 0) == evict
    assert int(body[0].occupied_mask(-10.0).sum()) > 0


def test_deskew_body_matches_eager():
    """The host engine's deskew against its former inline form: the
    clamped prediction's inverse as the sweep start, the identity as its
    end, VLP-16 time fractions."""
    rng = np.random.default_rng(3)
    pts = _room(rng, 900)
    cloud = PointCloud.from_points_host(pts, 1024, device="cpu",
                                        attrs=rng.uniform(
                                            0, 1, (900, 1)).astype(
                                                np.float32))
    eng = _engine(True, deskew=True)
    # a motion past the clamp, so the clamp acts
    delta = se3.exp(torch.tensor([0.9, 0.1, 0.0, 0.02, 0.0, 0.4]))
    pred = eng._clamped_delta(delta)
    inline = deskew_cloud(cloud, vlp16_time_fractions(cloud.points),
                          T_start=se3.inverse(pred),
                          T_end=torch.eye(4, dtype=torch.float32))
    with _no_host_reads():
        body = eng._deskew(cloud, delta)
    _same(inline, body)
    _same(inline, _engine(False, deskew=True)._deskew(cloud, delta))
    assert body.attrs is cloud.attrs and body.mask is cloud.mask
    assert not torch.equal(body.points, cloud.points)


def test_host_engine_with_every_option_matches_eager():
    """Three scans moving through the room with the pyramid, occupancy
    and deskew on: poses, metrics, the map and the grid bit for bit."""
    rng = np.random.default_rng(11)
    world = np.concatenate([_room(rng, 6000),
                            rng.normal([1.0, 1.0, 0.0], 0.2, (400, 3))])
    clouds, gt = [], []
    for k in range(3):
        T = se3.exp(torch.tensor([0.12 * k, 0.05 * k, 0.0, 0.0, 0.0,
                                  0.02 * k])).numpy()
        local = (world.astype(np.float32) - T[:3, 3]) @ T[:3, :3]
        clouds.append(PointCloud.from_points_host(
            local[rng.random(len(local)) < 0.5].astype(np.float32), 4096,
            device="cpu"))
        gt.append(T)
    runs = []
    for compiled in (False, True):
        eng = _engine(compiled, pyramid_factor=2, use_occupancy=True,
                      occupancy_evict_below=-0.3, deskew=True)
        state = eng.init_state(gt[0])
        for c in clouds:
            state, _ = eng.step(state, c)
        runs.append((state, [dataclasses.replace(m, wall_time_s=0.0)
                             for m in eng.metrics.records],
                     eng.field_builds))
    (s0, m0, b0), (s1, m1, b1) = runs
    assert m0 == m1 and b0 == b1 >= 2
    _same((s0.pose, s0.last_delta, s0.vmap, s0.occ),
          (s1.pose, s1.last_delta, s1.vmap, s1.occ))
    err = np.linalg.norm(s1.pose.numpy()[:3, 3] - gt[-1][:3, 3])
    assert err < 0.1
