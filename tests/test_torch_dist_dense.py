"""The sharded dense-window odometry step (tpu_slam_torch.distributed.
dense_shard) against tpu_slam.distributed.dense_shard and the port's
single-device DenseLidarOdometry, on the CPU.

Three steps through the office from the single engine's first window
(0.4 m cells, a (32, 32, 16) window that cuts the office's far walls, so
the matched fraction stays below 1), the same downsampled scans (numpy)
for all three. The reference runs on two virtual CPU devices with its
raster kernel swapped for a wrapper of ``ndt_terms_raster_reference`` that
honours ``owned_planes``; the port on 2 and 4 gloo ranks.

Tolerances: every step's pose within 1e-4 of the single engine and of the
reference's sharded step (the reference's own bar, tests/test_distributed.
py), every rank's pose bit-identical, the iterations and the matched
fraction the single engine's exactly (the seam rule: a point is counted on
the rank that bins it). The insert gate is a named divergence from the
reference, which inserts every accepted scan: the port also gates on
``min_insert_fraction``, as the single engine does.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.distributed.dense_shard import \
    dense_step_sharded as j_dense_step_sharded
from tpu_slam.distributed.mesh import make_mesh
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.distributed.dense_shard import dense_step_sharded
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
from tpu_slam_torch.registration.ndt import NDTParams

from tests import test_torch_dist_ranks as R
from tests.test_torch_dist_map import _reference_terms

DIMS = (32, 32, 16)
N_STEPS = 3
KW = dict(max_iterations=10, coarse_iterations=2, tolerance=3e-4,
          min_voxel_count=3.0, raster_q=8, window_dims=DIMS)
GATES = {"insert": dict(min_accept_fraction=0.3, min_insert_fraction=0.3),
         "gated": dict(min_accept_fraction=0.3, min_insert_fraction=0.95)}


def _cfg(min_insert_fraction):
    return OdometryConfig(scan_capacity=4096, downsample_leaf=0.25,
                          map_leaf=0.4, map_half_extent=16.0,
                          insert_downsampled=True, deskew=False,
                          scan_max_range=0.0,
                          min_insert_fraction=min_insert_fraction,
                          ndt=NDTParams(**KW), pyramid_factor=1,
                          rebase_fraction=10.0)   # deadband: never scroll


@pytest.fixture(scope="module")
def case():
    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(N_STEPS + 1):
        T = syn.se2_pose(0.3 * k - 0.4, 0.05 * k, 0.06 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, noise_std=0.005, rng=rng, device="cpu")
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=8192,
                                                  device="cpu"))
        gt.append(np.asarray(T, np.float32))

    single = {}
    for name, gates in GATES.items():
        od = DenseLidarOdometry(_cfg(gates["min_insert_fraction"]),
                                device="cpu")
        state = od.init_state(clouds[0], torch.as_tensor(gt[0]))
        if name == "insert":
            rows0 = state.grid.rows.numpy().copy()
            oc = state.grid.origin_cell.numpy().copy()
            scans = [(s.points.numpy(), s.mask.numpy()) for s in
                     (od.downsample(c) for c in clouds[1:])]
        poses, metrics = [], []
        for c in clouds[1:]:
            state = od.step(state, c)
            poses.append(state.pose.numpy())
            metrics.append(state.last_metrics.numpy())
        single[name] = dict(poses=np.stack(poses), metrics=np.stack(metrics),
                            rows=state.grid.rows.numpy())

    spec = _cfg(0.3).map_spec()
    params = NDTParams(**KW)
    cases = [(name, params, gates) for name, gates in GATES.items()]
    pool = ThreadPoolExecutor(2)
    port = {2: pool.submit(M.run_ranks, R.dense_body, 2, rows0, oc, gt[0],
                           scans, spec, DIMS, cases, device="cpu"),
            4: pool.submit(M.run_ranks, R.dense_body, 4, rows0, oc, gt[0],
                           scans, spec, DIMS, cases[:1], device="cpu")}

    # the reference's sharded step (no insert gate but acceptance)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    jspec = JSpec.centered(leaf=0.4, half_extent=16.0)
    jparams = JParams(**KW, terms_impl="pallas_interpret")
    mesh = make_mesh(2)
    rows, pose = jnp.asarray(rows0), jnp.asarray(gt[0])
    delta = jnp.eye(4, dtype=jnp.float32)
    ref_poses, ref_metrics = [], []
    for pts, mask in scans:
        rows, pose, delta, m = j_dense_step_sharded(
            mesh, rows, jnp.asarray(oc), pose, delta,
            JCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)), jspec,
            DIMS, params=jparams, min_accept_fraction=0.3)
        ref_poses.append(np.asarray(pose))
        ref_metrics.append(np.asarray(m))
    mp.undo()
    port = {n: f.result() for n, f in port.items()}
    pool.shutdown()
    return dict(single=single, port=port, rows0=rows0,
                ref=dict(poses=np.stack(ref_poses),
                         metrics=np.stack(ref_metrics)))


@pytest.mark.parametrize("n", [2, 4])
def test_dense_step_matches_single_engine_and_reference(case, n):
    ranks = [out["insert"] for out in case["port"][n]]
    one = case["single"]["insert"]
    assert M.rank_results_equal([r["poses"] for r in ranks])
    got = ranks[0]
    for k in range(N_STEPS):
        np.testing.assert_allclose(got["poses"][k], one["poses"][k],
                                   atol=1e-4)
        np.testing.assert_allclose(got["poses"][k], case["ref"]["poses"][k],
                                   atol=1e-4)
    # iterations, matched fraction, accepted, inserted: the engine's
    np.testing.assert_array_equal(got["metrics"][:, :4], one["metrics"][:, :4])
    assert (got["metrics"][:, 3] == 1.0).all()
    assert ((got["metrics"][:, 1] < 1.0)
            & (got["metrics"][:, 1] >= case["ref"]["metrics"][:, 1])).all()
    # the ranks' chunks tile the engine's window
    rows = np.concatenate([r["rows"] for r in ranks])
    np.testing.assert_allclose(rows, one["rows"], rtol=0,
                               atol=1e-5 * np.abs(one["rows"]).max())


def test_insert_gates_on_min_insert_fraction(case):
    """The matched fraction lies between the accept and insert thresholds:
    the single engine and the port accept without inserting; the
    reference's sharded step inserts (it gates on acceptance only)."""
    got = case["port"][2][0]["gated"]
    one = case["single"]["gated"]
    frac = got["metrics"][:, 1]
    assert ((frac >= 0.3) & (frac < 0.95)).all()
    np.testing.assert_array_equal(got["metrics"][:, :4], one["metrics"][:, :4])
    assert (got["metrics"][:, 2] == 1.0).all()        # accepted
    assert (got["metrics"][:, 3] == 0.0).all()        # not inserted
    rows = np.concatenate([out["gated"]["rows"] for out in case["port"][2]])
    np.testing.assert_array_equal(rows, case["rows0"])
    np.testing.assert_array_equal(one["rows"], case["rows0"])
    for k in range(N_STEPS):
        np.testing.assert_allclose(got["poses"][k], one["poses"][k],
                                   atol=1e-4)
    # the reference inserted the same accepted scans
    assert (case["ref"]["metrics"][:, 3] == 1.0).all()


def test_dense_step_rejects_unshardable_dims():
    mesh = M.Mesh(None, 0, 3, "data", "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="not shardable"):
        dense_step_sharded(mesh, torch.zeros(1, 10), torch.zeros(3),
                           torch.eye(4), torch.eye(4),
                           PointCloud(points=torch.zeros(1, 3),
                                      mask=torch.zeros(1, dtype=torch.bool)),
                           _cfg(0.3).map_spec(), DIMS, NDTParams(**KW))
