"""The ``host-slam-survey`` cell: its manifest entries, its readers, and
a tiny copy of it on the CPU (``tiny_survey``), correct as the port runs
it (traced: the readers find the driver's span totals of the window) and
not correct with a fault planted underneath: a line dropped at every
stop, the odometry's pose moved 2 cm, the map rebuild after a loop
skipped, the map rebuilt at the graph's poses from before the loop's
solve."""

import dataclasses
import json
import time

import pytest
import torch

from slambench import plugins
from slambench.run import run_cell
from slambench.tests.tiny_cells import REPO
from slambench.tests.tiny_survey import make_root
from slambench.trace import Trace
from tpu_slam_torch.pipeline import slam as slam_mod
from tpu_slam_torch.pipeline.live import LivePipeline
from tpu_slam_torch.pipeline.odometry import LidarOdometry

CELL = "host-slam-survey"
READERS = {"line_ms_per_scan": "live.line",
           "host_register_ms_per_scan": "host.register",
           "host_insert_ms_per_scan": "host.insert",
           "host_field_ms_per_build": "host.field"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_entries(manifest):
    cell = [w for w in manifest["workloads"] if w["name"] == CELL]
    assert len(cell) == 1 and cell[0]["chips"] == 1
    assert cell[0]["config"] == "m3d_survey_host"
    assert cell[0]["traffic"] == "corridor_survey"
    conf = [c for c in manifest["configs"] if c["name"] == "m3d_survey_host"]
    assert len(conf) == 1 and conf[0]["reduced"] == []
    assert len(conf[0]["source"]) <= 200
    cfg = json.loads((REPO / conf[0]["file"]).read_text())
    assert cfg["system"] == "survey_slam" and cfg["reduced"] == []
    assert cfg["assumed"] and cfg["sensor"]["model"] == "lms100_rotating"
    assert (cfg["sensor"]["beams"], cfg["sensor"]["step_deg"],
            cfg["sensor"]["lines"]) == (541, 0.5, 150)
    assert cfg["slam"]["odometry_engine"] == "host"
    assert cfg["live"]["start_angle_deg"] == -135.0
    assert set(cfg["check"]["limits"]) >= {"cloud_count_mismatches",
                                           "rebuild_mismatches",
                                           "keyframe_mismatches"}
    traffic = json.loads((REPO / "slambench/traffic/corridor_survey.json")
                         .read_text())
    assert traffic["route"]["step"] == 0.45
    assert traffic["route"]["speed_var"] == 0.0
    assert (traffic["scans"], traffic["repeat"]) == (1200, False)
    assert traffic["profile"]["scans"] >= 6
    assert traffic["profile"]["min_sweeps"] >= 1
    per = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "scans_per_s"
        assert per[name]["unit"] == "ms"


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader(name):
    reader = plugins.load("metrics", name)
    t = Trace(scans=2, window_s=1.0, device_ops=[], host_counts={})
    assert reader.read(t) is None
    t.stage_counts = {"scans": 4, "host_field_builds": 5}
    assert reader.read(t) is None
    t.stages = {READERS[name]: 0.02}
    per = 5 if name == "host_field_ms_per_build" else 4
    assert reader.read(t) == pytest.approx(20.0 / per)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("survey"))


def test_tiny_survey_matches_the_port(root):
    out = run_cell(root, "tiny-survey", 31415926535, 12.0, True,
                   device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["info"]["loops"] > 0 and out["info"]["rebuilds"]
    assert out["checks"]["pose_gap_p50_mm"]["value"] < 1e-3
    assert out["checks"]["cloud_gap_mm"]["value"] < 1e-2
    assert out["checks"]["trigger_mismatches"]["value"] == 0
    for name in READERS:
        assert out["metrics"][name]["value"] > 0, name


def line_dropped(feed):
    def broken(self, ranges, intensities, angle):
        self._fed = getattr(self, "_fed", 0) + 1
        if self._fed % 24 == 6:
            return None
        return feed(self, ranges, intensities, angle)
    return broken


def pose_moved(step):
    def broken(self, state, cloud):
        new, m = step(self, state, cloud)
        if state.scan_index < 20:
            return new, m
        pose = new.pose.clone()
        pose[0, 3] += 0.02
        return dataclasses.replace(new, pose=pose), m
    return broken


def rebuild_skipped(reanchor):
    def broken(self, state):
        out = reanchor(self, state)
        return dataclasses.replace(out, odom=dataclasses.replace(
            out.odom, vmap=state.odom.vmap, field=state.odom.field))
    return broken


def rebuild_at_pre_loop_poses(close_loops):
    def broken(self, state):
        pre = state.graph.poses.clone()
        real = slam_mod._rebuild_map_batched

        def rebuild(poses, *args, **kwargs):
            return real(pre, *args, **kwargs)

        slam_mod._rebuild_map_batched = rebuild
        try:
            return close_loops(self, state)
        finally:
            slam_mod._rebuild_map_batched = real
    return broken


@pytest.mark.parametrize("target, name, fault, caught_by", [
    (LivePipeline, "feed_line", line_dropped, "cloud_count_mismatches"),
    (LidarOdometry, "step", pose_moved, "pose_gap_p50_mm"),
    (slam_mod.SLAMSystem, "_reanchor", rebuild_skipped,
     "rebuild_mismatches"),
    (slam_mod.SLAMSystem, "_close_loops", rebuild_at_pre_loop_poses,
     "rebuild_mismatches")])
def test_faults(root, monkeypatch, target, name, fault, caught_by):
    monkeypatch.setattr(target, name, fault(getattr(target, name)))
    out = run_cell(root, "tiny-survey", 27182818284, 8.0, False,
                   device="cpu", t0=time.perf_counter())
    assert not out["correct"], out["checks"]
    c = out["checks"][caught_by]
    assert c["value"] > c["limit"], out["checks"]
