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


# ---------------------------------------------------------------------------
# The CLIs of the live chain, the calibration, SLAM and the dataset tools
# ---------------------------------------------------------------------------

SMALL_SLAM = ["odometry.scan_capacity=4096", "odometry.downsample_leaf=0.3",
              "odometry.map_half_extent=16.0",
              "odometry.map_capacity=16384", "keyframe_cloud_capacity=2048",
              "keyframe_capacity=16", "edge_capacity=64"]


def _main_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def test_run_live_against_the_fakes(tmp_path):
    """run_live on a fake LMS100 (181 beams, read at LiveConfig()'s -45
    degrees) and a fake motor controller on loopback, on the CPU: two 3D
    scans printed, the speed commanded, then the unit stopped."""
    import chip_smoke as cs
    from tpu_slam_torch.cli.run_live import main as run_live
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

    enc_res, per_line, n_lines, beams = 10000, 100, 130, 181
    ticks = np.arange(n_lines) * per_line
    angles = -2.0 * np.pi * (ticks % enc_res) / enc_res
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    T_bl = [chain.base_from_laser(float(a)).numpy() for a in angles]
    pose = syn.se2_pose(0.5, -0.3, 0.2, z=0.5)
    ranges = cs.render_lines(syn.default_office(), [pose] * n_lines, T_bl,
                             beams=beams, start_deg=-45.0)
    tg = [cs.lms_telegram(r, k, start_deg=-45.0)
          for k, r in enumerate(ranges)]
    lms = cs.FakeLms(tg, period_s=0.005)
    m3d = cs.FakeM3d(ticks=lambda k: ticks[min(k, n_lines - 1)],
                     enc_res_hw=enc_res // 4)
    argv = ["--lms-host", "127.0.0.1", "--lms-port", str(lms.port),
            "--m3d-host", "127.0.0.1", "--m3d-port", str(m3d.port),
            "--speed", "12", "--scans", "2", "--json", "--device", "cpu",
            "--calibration", str(tmp_path / "calib.yaml")]
    for s in SMALL_SLAM:
        argv += ["--set", s]
    try:
        lines = _main_json(run_live, argv)
    finally:
        lms.stop()
        lms.join()
        m3d.join()
    scans = [r for r in lines if "n_points" in r]
    assert len(scans) == 2 and all(r["n_points"] > 1000 for r in scans)
    assert scans[0]["is_keyframe"] and scans[1]["matched_fraction"] > 0.5
    assert lines[-1]["n_scans"] == 2 and lines[-1]["dropped_lines"] == 0
    speed = [(0x3003, 0x0, 3), (0x3000, 0x10, 12), (0x3000, 0x1, 0),
             (0x3000, 0x1, 49)]
    assert m3d.writes[:4] == speed
    assert m3d.writes[-4:] == [(0x3003, 0x0, 3), (0x3000, 0x10, 0),
                               (0x3000, 0x1, 0), (0x3000, 0x1, 49)]
    # the identity calibration file was created where it was asked for
    assert json.load(open(tmp_path / "calib.yaml")) == [[0, 0, 0],
                                                        [0, 0, 0, 1]]


def test_run_live_refuses_without_cuda(monkeypatch):
    from tpu_slam_torch.cli.run_live import main as run_live

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_live(["--lms-host", "127.0.0.1", "--m3d-host", "127.0.0.1"])


def test_run_calibration_demo_small(monkeypatch, tmp_path):
    """--demo on a 60 x 91 capture, twiddle: the reference-format yaml
    (read by tpu_slam's Calibration), the verification, the red/green ply,
    and --min-matched refusing to persist a bad solve."""
    from tpu_slam.ingest.frames import Calibration as JCalibration
    from tpu_slam_torch.cli import run_calibration as rc

    demo = rc.demo_data
    monkeypatch.setattr(rc, "demo_data",
                        lambda device: demo(device, n_segments=60,
                                            n_beams=91))
    out = str(tmp_path / "m3d_calibration.yaml")
    ply = str(tmp_path / "check.ply")
    rec = _main_json(rc.main, [
        "--demo", "--method", "twiddle", "--max-evaluations", "20",
        "--out", out, "--verify-ply", ply, "--json", "--device", "cpu"])[-1]
    assert rec["evaluations"] >= 20 and rec["method"] == "twiddle"
    assert rec["true_params5"] == pytest.approx(
        [0.015, -0.01, 0.01, -0.012, 0.018])
    assert rec["verification_passed"] and rec["calibration_file"] == out
    assert rec["verification"]["ply_path"] == ply and os.path.exists(ply)
    cal = JCalibration.load(out)
    assert len(cal.translation) == 3 and len(cal.orientation_xyzw) == 4
    with pytest.raises(SystemExit):
        with contextlib.redirect_stdout(io.StringIO()):
            rc.main(["--demo", "--method", "twiddle", "--max-evaluations",
                     "2", "--min-matched", "1.01",
                     "--out", str(tmp_path / "refused.yaml"), "--json",
                     "--device", "cpu"])
    assert not os.path.exists(tmp_path / "refused.yaml")
    with pytest.raises(SystemExit):
        rc.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from tpu_slam_torch.cli.make_dataset import main as make_dataset

    out = str(tmp_path_factory.mktemp("ds") / "seq")
    rec = _main_json(make_dataset, [
        "--out", out, "--n-scans", "6", "--trajectory", "arc",
        "--n-azimuth", "240", "--json", "--device", "cpu"])[-1]
    assert rec == {"dataset": out, "n_scans": 6}
    return out


def test_make_dataset_equals_reference(tiny_dataset, tmp_path):
    from tpu_slam.cli.make_dataset import main as j_make_dataset

    ref = str(tmp_path / "ref")
    with contextlib.redirect_stdout(io.StringIO()):
        j_make_dataset(["--out", ref, "--n-scans", "6", "--trajectory",
                        "arc", "--n-azimuth", "240", "--json"])
    _same_dataset(tiny_dataset, ref)


def _same_dataset(a, b):
    with open(os.path.join(a, "index.json")) as f:
        ia = json.load(f)
    with open(os.path.join(b, "index.json")) as f:
        ib = json.load(f)
    assert ia == ib
    for e in ia["scans"]:
        with np.load(os.path.join(a, e["file"])) as x, \
                np.load(os.path.join(b, e["file"])) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])


def test_pcap_convert_equals_reference(tmp_path):
    from tpu_slam.cli.pcap_convert import pcap_to_dataset as j_convert
    from tpu_slam_torch.cli.pcap_convert import main as pcap_convert

    traj = np.stack([syn.se2_pose(0.3 * k, 0.0, 0.05 * k, z=1.2)
                     for k in range(3)])
    pcap = syn.synthesize_vlp16_pcap(str(tmp_path / "cap.pcap"),
                                     syn.default_office(), traj,
                                     n_azimuth=360, device="cpu")
    gt = str(tmp_path / "gt.npz")
    np.savez(gt, poses=traj)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        pcap_convert(["--pcap", pcap, "--out", str(tmp_path / "port"),
                      "--gt", gt])
    n = j_convert(pcap, str(tmp_path / "ref"), gt_poses=traj)
    assert buf.getvalue().strip() == f"wrote {n} scans to {tmp_path}/port"
    assert n >= 2
    _same_dataset(str(tmp_path / "port"), str(tmp_path / "ref"))


def test_run_slam_with_a_checkpoint(tiny_dataset, tmp_path):
    """run_slam over the dataset with a checkpoint every 3 scans, then a
    resume from the scan-3 checkpoint: the resumed poses equal the full
    run's tail bit for bit; the trajectory and the map are written."""
    from tpu_slam_torch.cli.run_slam import main as run_slam

    common = ["--dataset", tiny_dataset, "--json", "--device", "cpu",
              "--input-capacity", "4096"]
    for s in SMALL_SLAM:
        common += ["--set", s]
    full = str(tmp_path / "full")
    rec = _main_json(run_slam, common + ["--out", full])[-1]
    assert rec["n_keyframes"] >= 2 and rec["ate_rmse_m"] < 0.1
    poses = np.load(os.path.join(full, "trajectory.npz"))["poses"]
    assert poses.shape == (6, 4, 4)
    with np.load(os.path.join(full, "map.npz")) as m:
        assert int((m["count"] > 0).sum()) > 100

    ckpt = str(tmp_path / "ckpt.npz")
    _main_json(run_slam, common + ["--checkpoint", ckpt,
                                   "--checkpoint-every", "3"])
    # the last save is the end of the run; write the scan-3 one again
    from tpu_slam_torch.pipeline.checkpoint import load_checkpoint
    assert load_checkpoint(ckpt, device="cpu")[1]["scan_index"] == 6
    part = str(tmp_path / "part")
    from tpu_slam_torch.ingest.dataset import DatasetReader, DatasetWriter
    reader = DatasetReader(tiny_dataset)
    w = DatasetWriter(part)
    for k in range(3):
        w.append(reader[k])
    _main_json(run_slam, ["--dataset", part, "--json", "--device", "cpu",
                          "--input-capacity", "4096", "--checkpoint",
                          ckpt, "--checkpoint-every", "3"]
               + [x for s in SMALL_SLAM for x in ("--set", s)])
    resumed = str(tmp_path / "resumed")
    rec = _main_json(run_slam, common + ["--checkpoint", ckpt, "--resume",
                                         "--out", resumed])[-1]
    tail = np.load(os.path.join(resumed, "trajectory.npz"))["poses"]
    np.testing.assert_array_equal(tail, poses[3:])
    assert "ate_rmse_m" not in rec                  # a partial trajectory
    with pytest.raises(SystemExit):
        run_slam(common + ["--resume"])
