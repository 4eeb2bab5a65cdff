"""The m3d survey's path on the CPU: the rotating unit's lines through
``LivePipeline.feed_line`` into ``SLAMSystem`` on the host engine, held
to the benchmark's plain reference (``slambench/reference``) on a tiny
survey of 8 stops, 32 beams and 12 lines a stop.

* The aggregated clouds against the reference's assembly of the same
  lines: the counts exactly, the points within 1e-5 m (the port builds
  each line's transform from float32 quaternions, the reference from the
  float64 closed form cast to float32).
* The host engine's poses and gates against the reference's
  registration of every stop from the same prediction and map: within
  1e-5 m and 1e-5 rad (the two maps sum the same points in other orders:
  the port's incremental merge, the reference's unique and scatter-add),
  the accept and insert decisions equal.
* One map rebuild after a forced loop (the graph's poses moved, then the
  re-anchor) against the reference's rebuild from the same keyframes:
  the same cells and points, moments within 1e-4 of their size.
* ``feed_line`` against ``LivePipeline.run`` over the loopback on the
  same lines: the clouds bit-equal.
* The spans and counters of the line and of the host engine recorded
  under ``tracing.enable()``, and none with the recorder off.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from slambench import world
from slambench.reference.aggregator import assemble, beam_directions
from slambench.reference.host_odometry import HostOdometryReference
from slambench.reference.odometry import pose_gap
from slambench.reference.pointcloud import PointCloud as RefCloud
from slambench.reference.voxel_map import rebuilt
from slambench.sensors import lms100_rotating as lms
from tpu_slam_torch.core import se3
from tpu_slam_torch.graph.loop_closure import LoopClosureParams
from tpu_slam_torch.ingest.aggregator import AggregatorConfig
from tpu_slam_torch.ingest.frames import FrameChain, SensorModel
from tpu_slam_torch.ingest.native import NativeLms, parse_telegram_native
from tpu_slam_torch.ingest.sick_cola import format_telegram
from tpu_slam_torch.mapping.voxel_map import INVALID_KEY
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline
from tpu_slam_torch.pipeline.slam import SLAMSystem
from tpu_slam_torch.utils import tracing

STOPS, BEAMS, LINES = 8, 32, 12
STEP_DEG = 270.0 / (BEAMS - 1)
SENSOR = dict(model="lms100_rotating", beams=BEAMS, step_deg=STEP_DEG,
              start_deg=-135.0, lines=LINES, turn=1.1 * math.pi,
              max_range=20.0, min_range=0.5, noise_std=0.012, noise_seed=0)
LIVE = LiveConfig(start_angle_deg=-135.0, line_capacity=64,
                  aggregator=AggregatorConfig(capacity=1024, line_length=64))
SLAM = SLAMConfig(
    odometry=OdometryConfig(scan_capacity=1024, map_half_extent=16.0,
                            map_capacity=8192),
    keyframe_capacity=16, keyframe_cloud_capacity=256, edge_capacity=64,
    loop=LoopClosureParams(min_index_gap=100))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def survey():
    """The tiny survey's lines: (ranges (stops, lines, beams), the route,
    the sensor object with its drawn encoder phase)."""
    sensor = dict(SENSOR)
    patches = world.make_world({"kind": "ring_corridor",
                                "outer": [12.0, 10.0, 3.0],
                                "inner": [5.0, 3.0]})
    route = world.make_route({"shape": "rounded_rect", "half": [4.0, 3.0],
                              "corner_radius": 1.0, "z": 0.9, "step": 0.45},
                             STOPS)
    pts, _ = lms.scans(patches, route, sensor, 2718281828459, "cpu")
    ranges = np.stack([lms.line_ranges(p, sensor) for p in pts])
    return ranges, route, sensor


def _feed(pipe, ranges, sensor, stop):
    """A stop's lines through ``feed_line``; the scan its last one
    completed."""
    zeros = np.zeros(BEAMS, np.float32)
    angles = lms.line_angles(sensor, stop)
    outs = [pipe.feed_line(r, zeros, float(a)) for r, a in zip(ranges, angles)]
    assert all(o is None for o in outs[:-1]) and outs[-1] is not None
    return outs[-1]


@pytest.fixture(scope="module")
def ran(survey):
    """The survey through the port: each stop's cloud, the odometry's pose
    and matched fraction, and the pipeline."""
    ranges, route, sensor = survey
    slam = SLAMSystem(SLAM, device="cpu")
    pipe = LivePipeline(LIVE, slam=slam, device="cpu")
    pipe.begin(route[0], ang_step_deg=STEP_DEG)
    clouds, poses, fracs = [], [], []
    for stop in range(STOPS):
        cloud, m = _feed(pipe, ranges[stop], sensor, stop)
        clouds.append(cloud)
        poses.append(pipe.slam_state.odom.pose.clone())
        fracs.append(m.matched_fraction)
    return clouds, poses, fracs, pipe


def test_clouds_match_the_reference_assembly(survey, ran):
    ranges, _, sensor = survey
    dirs = beam_directions(BEAMS, -135.0, STEP_DEG)
    box = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    for stop, cloud in enumerate(ran[0]):
        mine = assemble(ranges[stop],
                        np.float32(lms.line_angles(sensor, stop)), dirs,
                        LIVE.range_min, LIVE.range_max, box, "cpu")
        theirs = cloud.points[cloud.mask]
        assert theirs.shape == mine.shape and mine.shape[0] > 100
        assert float((theirs - mine).abs().max()) < 1e-5


def test_reference_frame_chain_is_the_port_s():
    angles = np.linspace(0.0, 2.0 * math.pi, 13)
    from slambench.reference.aggregator import base_from_laser

    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    port = chain.base_from_laser(torch.as_tensor(angles, dtype=torch.float32))
    assert np.abs(port.numpy() - base_from_laser(np.float32(angles))
                  ).max() < 1e-6


def test_host_engine_matches_the_reference(ran):
    clouds, poses, fracs, _ = ran
    odo = dataclasses.asdict(SLAM.odometry)
    ref = HostOdometryReference(odo, "cpu")
    ref.start(RefCloud(points=clouds[0].points, mask=clouds[0].mask),
              poses[0])
    for i in range(1, STOPS):
        accepted = fracs[i] >= odo["min_accept_fraction"]
        inserted = accepted and fracs[i] >= odo["min_insert_fraction"]
        mine = ref.follow(RefCloud(points=clouds[i].points,
                                   mask=clouds[i].mask), poses[i], inserted,
                          register=True)
        dt, dr = pose_gap(mine.T, poses[i])
        assert dt < 1e-5 and dr < 1e-5, (i, dt, dr)
        assert (mine.accepted, mine.inserted) == (accepted, inserted)


def test_map_rebuild_after_a_forced_loop_matches_the_reference(ran):
    pipe = ran[3]
    slam, state = pipe.slam, pipe.slam_state
    n = state.n_keyframes
    assert n >= 2
    # the loop's correction: each keyframe pulled by a growing offset
    k = torch.arange(state.graph.poses.shape[0], dtype=torch.float32)
    xi = torch.zeros(k.shape[0], 6)
    xi[:, 0], xi[:, 1], xi[:, 5] = 0.03 * k, -0.02 * k, 0.01 * k
    moved = se3.exp(xi) @ state.graph.poses
    forced = dataclasses.replace(
        state, graph=dataclasses.replace(state.graph, poses=moved))
    after = slam._reanchor(forced)
    expect = moved[n - 1] @ se3.inverse(state.last_kf_pose) @ state.odom.pose
    assert torch.allclose(after.odom.pose, expect, atol=1e-6)
    vm = after.odom.vmap
    occ = vm.keys != INVALID_KEY
    ref = rebuilt(slam.odometry.map_spec, SLAM.odometry.map_capacity,
                  moved[:n], [(state.kf_points[j], state.kf_mask[j])
                              for j in range(n)], "cpu")
    assert torch.equal(vm.keys[occ], ref.keys)
    theirs = torch.cat([vm.count[occ, None], vm.sum_pts[occ],
                        vm.sum_outer[occ].reshape(-1, 9)], dim=1)
    assert torch.equal(theirs[:, 0], ref.moments[:, 0])
    scale = float(ref.moments.abs().max())
    assert float((theirs - ref.moments).abs().max()) < 1e-4 * scale


def test_feed_line_is_the_socket_path(survey):
    ranges, _, sensor = survey
    lines = ranges.reshape(-1, BEAMS)[:3 * LINES]
    angles = np.concatenate([lms.line_angles(sensor, s) for s in range(3)])
    telegrams = [format_telegram(np.round(r * 1000).astype(np.uint32),
                                 scan_no=k, start_angle_deg=-135.0,
                                 ang_step_deg=STEP_DEG)
                 for k, r in enumerate(lines)]
    live = LivePipeline(LIVE, device="cpu")
    dev = cs.FakeLms(telegrams, gate=lambda k: k < live.lines + 64)
    lms_dev = NativeLms(cap=LIVE.line_capacity)
    try:
        lms_dev.connect("127.0.0.1", dev.port)
        lms_dev.start_scan()
        socket = live.run(lms_dev, angle_source=cs.counter_source(angles),
                          max_lines=len(telegrams))
    finally:
        lms_dev.close()
        dev.join()
    # the replay takes the beam step from the recording, as the socket
    # path takes it from the first telegram
    offline = LivePipeline(LIVE, device="cpu")
    meta = parse_telegram_native(telegrams[0][1:-1])[0]
    offline.begin(ang_step_deg=meta.ang_step_deg)
    got = []
    for raw, a in zip(telegrams, angles):
        _, r, _ = parse_telegram_native(raw[1:-1])
        out = offline.feed_line(np.asarray(r, np.float32),
                                np.zeros(len(r), np.float32), float(a))
        if out is not None:
            got.append(out)
    assert len(socket) == len(got) == 3
    assert live.lines == offline.lines == len(telegrams)
    for (c1, m1), (c2, m2) in zip(socket, got):
        assert m1 is None and m2 is None
        assert torch.equal(c1.points, c2.points)
        assert torch.equal(c1.mask, c2.mask)


@pytest.mark.parametrize("recording", [True, False])
def test_spans_and_counters(survey, recording):
    ranges, route, sensor = survey
    pipe = LivePipeline(LIVE, slam=SLAMSystem(SLAM, device="cpu"),
                        device="cpu")
    pipe.begin(route[0], ang_step_deg=STEP_DEG)
    with tracing.enable():          # a new, empty stretch
        pass
    if recording:
        with tracing.enable():
            for stop in range(2):
                _feed(pipe, ranges[stop], sensor, stop)
    else:
        for stop in range(2):
            _feed(pipe, ranges[stop], sensor, stop)
    names = {s.name for s in tracing.spans()}
    counts = tracing.counters()
    ours = {"live.line", "host.prep", "host.field", "host.register",
            "host.insert"}
    if recording:
        assert ours <= names
        assert sum(s.name == "live.line" for s in tracing.spans()) \
            == 2 * LINES
        assert counts["live_lines"] == 2 * LINES
        assert counts["host_field_builds"] == 1
    else:
        assert not ours & names
        assert "live_lines" not in counts and "host_field_builds" not in counts


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    probe = ("import sys; import slambench.reference.host_odometry, "
             "slambench.reference.aggregator, slambench.reference.voxel_map; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'tpu_slam', 'tpu_slam_torch')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
