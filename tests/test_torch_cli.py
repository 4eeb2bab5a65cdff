"""The port's CLI (CPU): ``apply_overrides`` against tpu_slam's, and
``run_odometry --bag ... --device cpu`` on a tiny bag, with ``--engine
dense`` and with ``--engine sparse`` (the default), each against the port
engine's own run on the same scans.

Named divergences from the reference CLI:
  * a comma value for a field whose default is None falls back to the
    string when a part is not a number (the reference raises ValueError);
  * ``--device`` (default CUDA, which must be present) is the port's own;
  * both engines are imported when they are chosen (the reference imports
    the sparse engine at the module's top).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tpu_slam.cli.common import apply_overrides as j_apply
from tpu_slam.pipeline.config import OdometryConfig as JConfig
from tpu_slam_torch.cli.common import apply_overrides
from tpu_slam_torch.cli.run_odometry import main as run_odometry
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import rosbag as rb
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.ingest.dataset import DatasetReader
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.metrics import ate_rmse
from tpu_slam_torch.pipeline.odometry import LidarOdometry
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

SETS = ["scan_capacity=2048", "downsample_leaf=0.3", "map_leaf=0.5",
        "map_half_extent=16.0", "insert_downsampled=true",
        "ndt.max_iterations=8", "ndt.coarse_iterations=2",
        "ndt.min_voxel_count=3.0", "ndt.window_dims=24,24,8",
        "pyramid_factor=2", "max_pred_translation=2.0"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores: on two threads the
    port's small CPU ops run as fast as on all of them, and leave the rest
    to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_apply_overrides_matches_reference():
    got = apply_overrides(OdometryConfig(), SETS)
    ref = j_apply(JConfig(), SETS)
    assert got.ndt.window_dims == ref.ndt.window_dims == (24, 24, 8)
    for k in ("scan_capacity", "downsample_leaf", "map_leaf",
              "insert_downsampled", "pyramid_factor", "max_pred_translation"):
        assert getattr(got, k) == getattr(ref, k), k
    for k in ("max_iterations", "coarse_iterations", "min_voxel_count"):
        assert getattr(got.ndt, k) == getattr(ref.ndt, k), k
    for bad in (["nosuchfield=1"], ["map_leaf"], ["map_leaf.x=1"]):
        with pytest.raises(SystemExit):
            apply_overrides(OdometryConfig(), bad)
        with pytest.raises(SystemExit):
            j_apply(JConfig(), bad)


def test_apply_overrides_tuple_fallback_is_fixed():
    """Divergence, named: a non-numeric comma value for a None-default
    field is kept as the string; the reference raises ValueError."""
    with pytest.raises(ValueError):
        j_apply(JConfig(), ["ndt.window_dims=wide,flat"])
    cfg = apply_overrides(OdometryConfig(), ["ndt.window_dims=wide,flat"])
    assert cfg.ndt.window_dims == "wide,flat"
    mixed = apply_overrides(OdometryConfig(), ["ndt.window_dims=48,48.5,16"])
    assert mixed.ndt.window_dims == (48, 48.5, 16)


@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    """Three office scans in a bag, TF ground truth beside each."""
    tmp = tmp_path_factory.mktemp("cli")
    world = syn.default_office()
    rng = np.random.default_rng(0)
    path = str(tmp / "seq.bag")
    with rb.BagWriter(path) as w:
        for k in range(3):
            T = syn.se2_pose(0.15 * k - 0.3, 0.05 * k, 0.03 * k, z=1.2)
            pts, valid = syn.simulate_vlp16_revolution(
                world, T, n_azimuth=300, noise_std=0.005, rng=rng)
            q = se3.quat_from_matrix(torch.tensor(
                T[:3, :3], dtype=torch.float32)).numpy().astype(np.float64)
            t = 100.0 + k
            tf = rb.TransformStamped(stamp=t - 0.01, frame_id="odom",
                                     child_frame_id="velodyne",
                                     translation=T[:3, 3].copy(), rotation=q)
            w.write("/tf", "tf2_msgs/TFMessage",
                    rb.serialize_tf_message([tf]), t - 0.01)
            w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                    rb.serialize_pointcloud2(pts[valid], t, "velodyne"), t)
    return path


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_odometry(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_bag_replay_equals_the_engine(bag, tmp_path):
    out = str(tmp_path / "traj.npz")
    argv = ["--bag", bag, "--bag-gt-frame", "odom", "--json", "--engine",
            "dense", "--device", "cpu", "--input-capacity", "8192",
            "--out", out]
    for s in SETS:
        argv += ["--set", s]
    rec = _cli(argv)
    assert rec["n_scans"] == 2                        # steps after the first
    assert rec["bag_convert_s"] > 0 and rec["odometry_s"] > 0
    assert os.path.isdir(bag + ".dataset")

    reader = DatasetReader(bag + ".dataset")
    gt = reader.gt_poses()
    odo = DenseLidarOdometry(apply_overrides(OdometryConfig(), SETS),
                             device="cpu")
    clouds = [PointCloud.from_points_host(r.points[r.mask], capacity=8192,
                                          device="cpu") for r in reader]
    poses, log = odo.run(clouds, init_pose=gt[0])
    np.testing.assert_array_equal(np.load(out)["poses"], poses)
    assert rec["ate_rmse_m"] == ate_rmse(poses, gt, align=False) < 0.05
    assert rec["mean_matched_fraction"] == log.summary()[
        "mean_matched_fraction"]
    assert rec["rpe_trans_m"] < 0.05


def test_cli_sparse_engine_equals_the_engine(bag, tmp_path, capsys):
    """--engine sparse runs LidarOdometry: its poses equal the engine's
    own run on the same dataset bit for bit; its ATE is printed beside the
    dense engine's on the same bag."""
    common = ["--bag", bag, "--bag-gt-frame", "odom", "--json", "--device",
              "cpu", "--input-capacity", "8192"]
    for s in SETS:
        common += ["--set", s]
    out = str(tmp_path / "sparse.npz")
    rec = _cli(common + ["--engine", "sparse", "--out", out])
    dense = _cli(common + ["--engine", "dense"])
    assert rec["n_scans"] == 3              # the bootstrap scan included

    reader = DatasetReader(bag + ".dataset")
    gt = reader.gt_poses()
    odo = LidarOdometry(apply_overrides(OdometryConfig(), SETS),
                        device="cpu")
    clouds = [PointCloud.from_points_host(r.points[r.mask], capacity=8192,
                                          device="cpu") for r in reader]
    poses, log = odo.run(clouds, init_pose=gt[0])
    np.testing.assert_array_equal(np.load(out)["poses"], poses)
    assert rec["ate_rmse_m"] == ate_rmse(poses, gt, align=False) < 0.05
    assert rec["mean_matched_fraction"] == log.summary()[
        "mean_matched_fraction"]
    with capsys.disabled():
        print(f"\ntiny bag ATE: sparse engine {rec['ate_rmse_m']:.5f} m, "
              f"dense engine {dense['ate_rmse_m']:.5f} m")


def test_cli_refuses_the_sparse_engine_and_a_missing_gpu(bag, monkeypatch):
    """Both engines run (the sparse one is the default) and neither falls
    back to the CPU: without --device the run needs CUDA and stops before
    it starts when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ([], ["--engine", "sparse"], ["--engine", "dense"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_odometry(["--bag", bag, "--set", "ndt.window_dims=24,24,8"]
                         + engine)


def test_cli_module_imports_no_sparse_engine():
    """The reference imports LidarOdometry at module top; the port's CLI
    imports neither engine until one is chosen."""
    import ast

    import tpu_slam_torch.cli.run_odometry as mod

    tree = ast.parse(open(mod.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    names = {getattr(n, "module", None) or "" for n in top}
    assert not any(m.startswith("tpu_slam_torch.pipeline.odometry")
                   for m in names)
