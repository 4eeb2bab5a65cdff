"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip skipped (the CPU path), the rest of a run
driven as it is."""

import dataclasses
import time

import pytest
import torch

from slambench.run import run_cell
from slambench.tests.tiny_cells import make_root
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph import pose_graph
from tpu_slam_torch.pipeline import slam as slam_mod
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("faults"))


def unchanged(step):
    def broken(self, state, cloud):
        if int(state.scan_index) <= 3:
            return step(self, state, cloud)
        return state
    return broken


def half_scan(step):
    def broken(self, state, cloud):
        n = cloud.points.shape[0]
        keep = torch.arange(n) % 2 == 0
        return step(self, state, PointCloud(points=cloud.points,
                                            mask=cloud.mask & keep))
    return broken


def altered(step):
    def broken(self, state, cloud):
        out = step(self, state, cloud)
        pose = out.pose.clone()
        pose[0, 3] += 0.02
        return dataclasses.replace(out, pose=pose)
    return broken


@pytest.mark.parametrize("cell, seconds", [("tiny-odometry", 2.0),
                                           ("tiny-slam", 4.0)])
@pytest.mark.parametrize("fault", [unchanged, half_scan, altered])
def test_odometry_faults(root, monkeypatch, cell, seconds, fault):
    monkeypatch.setattr(DenseLidarOdometry, "step",
                        fault(DenseLidarOdometry.step))
    out = run_cell(root, cell, 77, seconds, False, device="cpu",
                   t0=time.perf_counter())
    assert not out["correct"], out["checks"]


def test_graph_answer_altered(root, monkeypatch):
    """The solve's optimized poses moved 2 cm after it returns."""
    solve = pose_graph.optimize_pose_graph

    def broken(graph, params, compiled=True):
        g, chi2 = solve(graph, params, compiled=compiled)
        poses = g.poses.clone()
        poses[:, 0, 3] += 0.02
        return dataclasses.replace(g, poses=poses), chi2

    monkeypatch.setattr(slam_mod, "optimize_pose_graph", broken)
    out = run_cell(root, "tiny-slam", 42, 12.0, False, device="cpu",
                   t0=time.perf_counter())
    assert out["info"]["loops"] > 0
    assert not out["correct"], out["checks"]
