"""The reference's last compiled programs: the calibration's cost and
gradient step, the Schur and the dense pose-graph solves, the sharded
dense step and the synthetic ray caster, their compiled forms against
their eager forms (CPU), bit for bit.

On the CPU ``compiled=True`` (``compiled=None`` on a mesh) runs the body
the card captures into a CUDA graph, eagerly; ``compiled=False`` runs the
eager form. Held here, with every read back to the host made to raise
inside the body: ``overlap_cost`` at two parameter vectors; a 3-step
gradient solve (history, parameters, Adam's moments and count) against
the same solve through ``.backward()`` into ``.grad``; a
20-evaluation twiddle and an annealing run taking the eager form's path;
the single-process Schur solve (one key for one structure);
``optimize_pose_graph``'s dense solver (one key for every node count at
the same capacities); the sharded dense step on a 1-rank gloo mesh, its
eager form against the sync-free body, and ``compiled=True`` on gloo
raising; the ray caster. Nothing here runs JAX: each module's parity with
the reference is in its own test file. The CUDA graphs themselves are held in ``test_torch_cuda.py``.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import dense_shard
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.distributed import schur
from tpu_slam_torch.graph import pose_graph as pg
from tpu_slam_torch.ingest import calibration as cal
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.utils.capture import signature, tensors_of

TRUE = np.array([0.02, -0.015, 0.012, -0.018, 0.025], np.float32)
CFG = cal.CalibConfig(half_extent=8.0, capacity=4096)


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


class _Programs:
    """A stand-in for a module's ``compiled_call`` on the CPU: runs the
    body with reads made to raise and records each call's cache key (its
    arguments' signature and static values), as ``replay`` keys a graph."""

    def __init__(self):
        self.keys = []

    def __call__(self, cache, fn, args, static=(), counters=()):
        self.keys.append(signature((tuple(args), static)))
        with _no_host_reads():
            return fn(*args)


# ---------------------------------------------------------------------------
# the calibration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    """64 segments x 90 beams of the reference test's room, the true mount
    carrying TRUE."""
    from tpu_slam_torch.cli.run_calibration import demo_data

    return demo_data("cpu", 64, 90, fov_deg=180.0, true=TRUE)[0]


def test_overlap_cost_body_matches_eager(capture, monkeypatch):
    """The count at the truth and at zero: the body with reads raising
    (one key for both vectors: the parameters are an input) against the
    eager form; the truth scores lower."""
    progs = _Programs()
    monkeypatch.setattr(cal, "compiled_call", progs)
    got = [int(cal.overlap_cost(capture, p, CFG))
           for p in (TRUE, np.zeros(5, np.float32))]
    want = [int(cal.overlap_cost(capture, p, CFG, compiled=False))
            for p in (TRUE, np.zeros(5, np.float32))]
    assert got == want and got[0] < got[1]
    assert len(progs.keys) == 2 and progs.keys[0] == progs.keys[1]


def test_gradient_step_matches_backward_and_optimizer(capture):
    """Three steps of the captured body (autograd.grad, the in-place
    update, the history slot) with reads raising, against soft_overlap_cost
    + .backward() into .grad + adam_update: history, parameters, moments
    and the step count bit for bit; then calibrate_gradient's two
    forms."""
    p0 = torch.zeros(5)
    state = cal.GradientState(params5=p0.clone(), adam=cal.adam_init(p0),
                              history=torch.zeros(3))
    with _no_host_reads():
        for _ in range(3):
            state = cal._gradient_step(state, capture, CFG, 3e-3)

    p = p0.clone().requires_grad_(True)
    adam = cal.adam_init(p.detach())
    history = []
    for _ in range(3):
        p.grad = None
        c = cal.soft_overlap_cost(capture, p, CFG)
        c.backward()
        cal.adam_update(p, p.grad, adam, 3e-3)
        history.append(c.detach())
    assert torch.equal(state.history, torch.stack(history))
    assert torch.equal(state.params5, p.detach())
    _same(state.adam, adam)
    assert int(state.adam.count) == 3

    res = [cal.calibrate_gradient(capture, CFG, steps=3, compiled=c)
           for c in (True, False)]
    assert np.array_equal(res[0].params5, res[1].params5)
    assert res[0].history == res[1].history == [float(h) for h in history]
    assert np.array_equal(res[0].params5, p.detach().numpy())
    assert res[0].cost == res[1].cost == float(
        int(cal.overlap_cost(capture, p.detach(), CFG)))


def test_adam_update_keeps_its_count_on_the_device():
    """The step count is a tensor of the parameters' device (a capture
    fixes no bias correction) and each step's update is optax's: the
    first step moves every parameter by the learning rate against its
    gradient's sign (g / (|g| + eps) in float32 with its bias corrections
    rounded: within 1e-4 of the rate at |g| = 3e-3)."""
    p = torch.zeros(5)
    state = cal.adam_init(p)
    g = torch.tensor([1.0, -2.0, 3e-3, -4e3, 5.0])
    cal.adam_update(p, g, state, 3e-3)
    assert state.count.dtype == torch.int32 and int(state.count) == 1
    np.testing.assert_allclose(p.numpy(), -3e-3 * np.sign(g.numpy()),
                               rtol=1e-4)


def test_twiddle_and_annealing_take_the_eager_path(capture):
    """A 20-evaluation twiddle and a short annealing run: the compiled
    form takes the eager form's accept/reject path (parameters, history,
    evaluations equal)."""
    tw = [cal.calibrate_twiddle(capture, CFG, max_evaluations=20,
                                compiled=c) for c in (True, False)]
    assert tw[0].evaluations == tw[1].evaluations >= 20
    assert np.array_equal(tw[0].params5, tw[1].params5)
    assert tw[0].history == tw[1].history and tw[0].cost < tw[0].history[0]
    kw = dict(t_start=0.5, t_end=0.05, alpha=0.7, step=0.005, seed=3)
    sa = [cal.calibrate_sa(capture, CFG, compiled=c, **kw)
          for c in (True, False)]
    assert sa[0].evaluations == sa[1].evaluations
    assert np.array_equal(sa[0].params5, sa[1].params5)
    assert sa[0].history == sa[1].history


# ---------------------------------------------------------------------------
# the Schur solve
# ---------------------------------------------------------------------------

def _spec():
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec

    return VoxelGridSpec.centered(leaf=0.4, half_extent=16.0)


def _circle_graph(seed=4, n=24, node_cap=32, edge_cap=64):
    """A noisy odometry circle of n poses with three loops (capacities
    node_cap, edge_cap)."""
    rng = np.random.default_rng(seed)
    gt = [se3.exp(torch.tensor([2.0 * math.sin(2 * math.pi * k / n),
                                2.0 * math.cos(2 * math.pi * k / n), 0.0,
                                0.0, 0.0, -2 * math.pi * k / n],
                               dtype=torch.float32)) for k in range(n)]
    g = pg.empty_graph(node_cap, edge_cap, device="cpu")
    est = torch.eye(4)
    for k in range(n):
        g, _ = pg.add_node(g, est)
        if k + 1 < n:
            Z = se3.inverse(gt[k]) @ gt[k + 1]
            noise = se3.exp(torch.from_numpy(
                rng.normal(0, 0.01, 6).astype(np.float32)))
            g = pg.add_edge(g, k, k + 1, Z @ noise)
            est = est @ Z @ noise
    for i, j in ((3, 13), (6, 18), (0, n - 1)):
        g = pg.add_edge(g, i, j, se3.inverse(gt[i]) @ gt[j],
                        info=10.0 * torch.eye(6))
    return g


DENSE_PARAMS = pytest.mark.parametrize("params", [
    pg.GraphSolveParams(gn_iterations=4, solver="dense"),
    pg.GraphSolveParams(gn_iterations=5, solver="dense", robust_delta=2.0,
                        robust_kernel="cauchy", robust_anneal=4.0)],
    ids=["plain", "robust"])


@DENSE_PARAMS
def test_schur_body_matches_eager(monkeypatch, params):
    """The single-process solve's body with reads raising against
    compiled=False: poses and χ² bit for bit, χ² a device scalar; a
    second solve of the graph has the first one's key, a graph with
    another loop another key."""
    g = _circle_graph()
    eager, echi = schur.optimize_pose_graph_schur(None, g, params,
                                                  compiled=False)
    progs = _Programs()
    monkeypatch.setattr(schur, "compiled_call", progs)
    got, chi = schur.optimize_pose_graph_schur(None, g, params)
    schur.optimize_pose_graph_schur(None, g, params, compiled=True)
    other = pg.add_edge(g, 9, 21, torch.eye(4))
    schur.optimize_pose_graph_schur(None, other, params)
    assert torch.equal(got.poses, eager.poses) and torch.equal(chi, echi)
    assert chi.shape == () and bool(torch.isfinite(chi))
    assert progs.keys[0] == progs.keys[1] != progs.keys[2]


@DENSE_PARAMS
def test_dense_solve_body_matches_eager(monkeypatch, params):
    """optimize_pose_graph's dense solver: its body with reads raising
    against compiled=False, poses and χ² bit for bit, χ² a () tensor; a
    second solve of the graph and the graph with one node (and edge) more
    at the same capacities (its solve bit-equal to its eager one, the new
    node moved) have the first one's key, other params another key."""
    g = _circle_graph()
    bigger, k = pg.add_node(g, g.poses[g.n_nodes - 1])
    bigger = pg.add_edge(bigger, k - 1, k, se3.exp(torch.tensor(
        [0.5, 0.0, 0.0, 0.0, 0.0, 0.1])))
    eager = [pg.optimize_pose_graph(x, params, compiled=False)
             for x in (g, bigger)]
    progs = _Programs()
    monkeypatch.setattr(pg, "compiled_call", progs)
    got, chi = pg.optimize_pose_graph(g, params)
    pg.optimize_pose_graph(g, params, compiled=True)
    got_b, chi_b = pg.optimize_pose_graph(bigger, params)
    pg.optimize_pose_graph(g, dataclasses.replace(params, damping=1e-5))
    assert torch.equal(got.poses, eager[0][0].poses)
    assert torch.equal(chi, eager[0][1])
    assert torch.equal(got_b.poses, eager[1][0].poses)
    assert torch.equal(chi_b, eager[1][1])
    assert not torch.equal(got_b.poses[k], bigger.poses[k])   # live
    assert chi.shape == () and bool(torch.isfinite(chi))
    assert got.n_nodes == g.n_nodes and got_b.n_nodes == g.n_nodes + 1
    k = progs.keys
    assert len(k) == 4 and k[0] == k[1] == k[2] != k[3]


def test_compiled_true_on_gloo_raises(monkeypatch):
    """A gloo mesh runs the eager forms; compiled=True there raises, for
    the Schur solve and the sharded step, and compiled=None on it never
    reaches a captured program."""
    mesh = M.Mesh(None, 0, 1, "data", "gloo", torch.device("cpu"))
    g = _circle_graph()
    with pytest.raises(ValueError, match="compiled=True needs NCCL"):
        schur.optimize_pose_graph_schur(mesh, g, compiled=True)
    with pytest.raises(ValueError, match="compiled=True needs NCCL"):
        dense_shard.dense_step_sharded(
            mesh, torch.zeros(8 * 8 * 8, 10), torch.zeros(3, dtype=torch.int32),
            torch.eye(4), torch.eye(4),
            PointCloud(torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool)),
            _spec(), (8, 8, 8), compiled=True)

    def never(*a, **k):
        raise AssertionError("a gloo mesh reached a captured program")

    monkeypatch.setattr(schur, "compiled_call", never)
    got, chi = schur.optimize_pose_graph_schur(
        mesh, g, pg.GraphSolveParams(gn_iterations=2, solver="dense"))
    assert bool(torch.isfinite(chi))
    assert M.captured_form(None, None) and not M.captured_form(mesh, None)
    assert not M.captured_form(mesh, False)


# ---------------------------------------------------------------------------
# the sharded dense step
# ---------------------------------------------------------------------------

DIMS = (32, 32, 16)


@pytest.fixture(scope="module")
def dense_case():
    return _dense_case()


def _dense_case():
    """The office window of a dense engine at pyramid_factor 1 after its
    first scan, and two downsampled scans after it (the card's tests use
    it too)."""
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam_torch.registration.ndt import NDTParams

    params = NDTParams(max_iterations=10, coarse_iterations=2,
                       tolerance=3e-4, min_voxel_count=3.0, raster_q=8,
                       window_dims=DIMS)
    cfg = OdometryConfig(scan_capacity=4096, downsample_leaf=0.25,
                         map_leaf=0.4, map_half_extent=16.0,
                         insert_downsampled=True, deskew=False,
                         scan_max_range=0.0, ndt=params, pyramid_factor=1,
                         rebase_fraction=10.0)
    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(3):
        T = syn.se2_pose(0.3 * k - 0.4, 0.05 * k, 0.06 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, noise_std=0.005, rng=rng, device="cpu")
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=8192,
                                                  device="cpu"))
        gt.append(torch.as_tensor(np.asarray(T, np.float32)))
    od = DenseLidarOdometry(cfg, device="cpu")
    state = od.init_state(clouds[0], gt[0])
    return dict(rows=state.grid.rows, oc=state.grid.origin_cell, pose=gt[0],
                scans=[od.downsample(c) for c in clouds[1:]],
                spec=cfg.map_spec(), params=params)


def test_sharded_step_eager_matches_sync_free_body(dense_case):
    """Two steps on a 1-rank gloo mesh: the eager form (compiled=None on
    gloo: the host-exit LM, the iteration count read back) against the
    sync-free body with reads raising: rows, pose, delta and metrics bit
    for bit; the body's fixed trips make more evaluations (all-reduces),
    the halo exchanges the same."""
    c = dense_case
    gates = dict(min_accept_fraction=0.3, min_insert_fraction=0.3,
                 max_pred_translation=0.7, max_pred_rotation=0.3)
    runs = []
    for form in ("eager", "body"):
        mesh = M.Mesh(None, 0, 1, "data", "gloo", torch.device("cpu"))
        rows, pose, delta = c["rows"].clone(), c["pose"], torch.eye(4)
        out = []
        for scan in c["scans"]:
            if form == "eager":
                res = dense_shard.dense_step_sharded(
                    mesh, rows, c["oc"], pose, delta, scan, c["spec"], DIMS,
                    c["params"], **gates)
            else:
                with _no_host_reads():
                    res = dense_shard._step_body(
                        mesh, rows, c["oc"], pose, delta, scan,
                        spec=c["spec"], dims=DIMS, params=c["params"],
                        sync_free=True, **gates)
            rows, pose, delta, metrics = res
            out.append(res)
        runs.append((out, dict(mesh.stats.calls)))
    (a, calls_a), (b, calls_b) = runs
    for x, y in zip(a, b):
        _same(x, y)
    assert calls_a["halo_exchange"] == calls_b["halo_exchange"] == 2
    assert calls_b["all_reduce"] >= calls_a["all_reduce"]
    metrics = a[-1][3]
    assert float(metrics[2]) == 1.0 and float(metrics[0]) >= 1


# ---------------------------------------------------------------------------
# the ray caster
# ---------------------------------------------------------------------------

def test_raycast_body_matches_eager(monkeypatch):
    """The office from one origin at 4M+ ray-patch pairs (the torch pass):
    the body with reads raising (one key for one (rays, patches)) against
    compiled=False, the ranges bit for bit, some rays hit and some miss."""
    world = syn.default_office()
    k = len(world.patches)
    n = -(-4_000_000 // k)
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = np.broadcast_to(np.float32([0.5, 0.3, 1.2]), dirs.shape)
    want = world.raycast(origins, dirs, max_range=6.0, device="cpu",
                         compiled=False)
    progs = _Programs()
    monkeypatch.setattr(syn, "compiled_call", progs)
    got = world.raycast(origins, dirs, max_range=6.0, device="cpu")
    again = world.raycast(origins, -dirs, max_range=6.0, device="cpu")
    assert np.array_equal(got, want)
    assert np.isfinite(got).any() and np.isinf(got).any()
    assert np.isfinite(again).any()
    assert len(progs.keys) == 2 and progs.keys[0] == progs.keys[1]
