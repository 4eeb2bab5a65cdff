"""The reference against the port at tiny sizes on the CPU, and a lower
precision in the program's place failing the comparison."""

import json
import time

import numpy as np
import pytest
import torch

from slambench import plugins, world
from slambench.run import run_cell
from slambench.tests.tiny_cells import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("ref"))


def test_odometry_matches_the_port(root):
    out = run_cell(root, "tiny-odometry", 123456789012, 2.0, False,
                   device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["pose_gap_p50_mm"]["value"] < 1e-3
    assert out["checks"]["gate_mismatches"]["value"] == 0


def test_slam_matches_the_port(root):
    out = run_cell(root, "tiny-slam", 42, 12.0, False, device="cpu",
                   t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["info"]["sweeps"] > 0 and out["info"]["loops"] > 0
    assert out["checks"]["graph_gap_mm"]["value"] < 1e-3


def test_lower_precision_fails(root):
    """The reference in the program's place with its downsampled scans in
    bfloat16 (the CPU has no TF32): its poses fail the check."""
    from slambench.reference.odometry import DenseOdometryReference
    from slambench.reference.pointcloud import PointCloud

    class Bf16(DenseOdometryReference):
        def downsample(self, cloud):
            s = super().downsample(cloud)
            return PointCloud(points=s.points.to(torch.bfloat16)
                              .to(torch.float32), mask=s.mask).sanitize()

    config = json.loads((root / "slambench/configs/tiny_odometry.json")
                        .read_text())
    traffic = json.loads((root / "slambench/traffic/tiny_laps.json")
                         .read_text())
    route = world.make_route(traffic["route"], traffic["scans"])
    pts, msk = world.make_scans(world.make_world(config["world"]), route,
                                config["sensor"], 9, "cpu")
    ref = Bf16(config["odometry"], "cpu")
    ref.start(PointCloud(points=pts[0], mask=msk[0]),
              torch.as_tensor(route[0]))
    poses, acc, ins = [ref.pose.numpy()], [True], [True]
    for i in range(1, 8):
        r = ref.forward(PointCloud(points=pts[i], mask=msk[i]))
        poses.append(r.T.numpy())
        acc.append(r.accepted)
        ins.append(r.inserted)
    record = dict(src=list(range(8)), poses=np.stack(poses),
                  accepted=np.asarray(acc), inserted=np.asarray(ins))
    limits = config["check"]["limits"]
    numbers = plugins.load("systems", "dense_odometry").check(
        config, pts, msk, record, 3, 9, "cpu")
    assert any(v > limits[n] for n, v in numbers.items()), numbers


def test_graph_solve_in_bf16_fails(root):
    """The graph control on the CPU: the reference's solve in the
    program's place, reading its inputs in bfloat16."""
    from slambench import control

    out = control.graph_in_bf16(root, "tiny-slam", 42, 12.0, device="cpu")
    assert out["info"]["solves"] > 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["graph_gap_mm"]["value"] > \
        out["checks"]["graph_gap_mm"]["limit"]


def test_kf_ate_reads_the_window_s_last_solved_graph():
    """``kf_ate``: the node positions of the window's last sweep that
    admitted a loop against the route at the nodes' scans; inf where the
    window solved none."""
    from types import SimpleNamespace

    from slambench.systems.slam import kf_ate

    truth = np.tile(np.eye(4), (12, 1, 1))
    truth[:, 0, 3] = np.arange(12.0)

    def sweep(step, kf, shift, admitted):
        poses = torch.zeros(16, 4, 4, dtype=torch.float32)
        poses[:len(kf)] = torch.as_tensor(truth[kf], dtype=torch.float32)
        poses[:len(kf), 1, 3] += shift
        poses[len(kf):, :3, 3] = 1e6            # capacity past n
        return dict(step=step, n=len(kf), kf_steps=list(kf) + [11],
                    post_graph=SimpleNamespace(poses=poses),
                    pre_loops={(0, 1)},
                    post_loops={(0, 1), (0, 2)} if admitted else {(0, 1)})

    sweeps = [sweep(3, [0, 1, 3], 0.5, True),
              sweep(7, [0, 3, 5, 7], 0.25, True),
              sweep(9, [0, 3, 5, 7, 9], 4.0, False)]
    assert kf_ate(sweeps, truth, 5) == pytest.approx(0.25)
    assert kf_ate(sweeps, truth, 2) == pytest.approx(0.25)
    assert kf_ate(sweeps, truth, 8) == float("inf")
