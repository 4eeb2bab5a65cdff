"""The port's live pipeline on loopback devices (CPU).

* The loopback stream of tests/test_native.py (a rotating capture in the
  office, 140 lines x 271 beams, as CoLa-A telegrams with the mm
  quantization) through the port's LivePipeline with the small SLAM
  config of that test; the same telegrams through tpu_slam's
  ScanAggregator alone, with no SLAM and no threads. The clouds agree
  (mask exact, points within 1e-5 m: float32 transforms in another
  order), no line is dropped, and SLAM yields one keyframe at the
  identity within 1e-5.
* The time-interpolated encoder join (tests/test_live_interp.py): every
  line's angle within one encoder tick of the true profile on average.
* The static front laser through ``run_front``, against the reference's
  front chain.
* Without CUDA the pipeline refuses to start unless the CPU is asked for.
"""

import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.ingest.aggregator import AggregatorConfig
from tpu_slam_torch.ingest.frames import FrameChain, SensorModel
from tpu_slam_torch.ingest.native import NativeLms, parse_telegram_native
from tpu_slam_torch.ingest.sick_cola import format_telegram
from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline

TICK = 2.0 * math.pi / 4096.0      # one encoder count (res 4x1024)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores: the port's small CPU ops
    run as fast on two threads and leave the rest to the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _telegrams(ranges_m, step_deg, start_deg=-135.0):
    return [format_telegram(np.round(r * 1000).astype(np.uint32), scan_no=k,
                            start_angle_deg=start_deg, ang_step_deg=step_deg)
            for k, r in enumerate(ranges_m)]


def _run(pipe, telegrams, angle_source, period_s, gated=False, **kw):
    """Stream ``telegrams`` from a fake LMS100 through ``pipe``: one every
    ``period_s``, or (``gated``) as fast as the consumer takes them, never
    more than 64 lines ahead of it (the feeder holds 128)."""
    gate = (lambda k: k < pipe.lines + 64) if gated else None
    dev = cs.FakeLms(telegrams, period_s=period_s, gate=gate)
    lms = NativeLms(cap=1024)
    try:
        lms.connect("127.0.0.1", dev.port)
        lms.start_scan()
        return pipe.run(lms, angle_source=angle_source, **kw)
    finally:
        lms.close()
        dev.join()


def _reference_clouds(telegrams, angles, cfg, offset):
    """tpu_slam's chain on the same telegrams: no threads, no SLAM."""
    from tpu_slam.ingest.aggregator import AggregatorConfig as JConfig
    from tpu_slam.ingest.aggregator import ScanAggregator
    from tpu_slam.ingest.frames import FrameChain as JChain
    from tpu_slam.ingest.frames import SensorModel as JSensor

    agg = ScanAggregator(JConfig(capacity=cfg.aggregator.capacity,
                                 line_length=cfg.line_capacity))
    chain = JChain(sensor=JSensor.by_name("LMS100"), encoder_offset=offset)
    state, clouds, dirs = agg.init_state(), [], None
    for raw, a in zip(telegrams, angles):
        meta, r, _ = parse_telegram_native(raw[1:-1])
        n = r.shape[0]
        if dirs is None:
            ang = (math.radians(cfg.start_angle_deg)
                   + math.radians(meta.ang_step_deg) * np.arange(n))
            dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)],
                            axis=1).astype(np.float32)
        p = np.zeros((cfg.line_capacity, 3), np.float32)
        v = np.zeros((cfg.line_capacity,), bool)
        p[:n] = dirs * r[:, None]
        v[:n] = (r >= cfg.range_min) & (r <= cfg.range_max)
        state = agg.add_line(state, jnp.asarray(p), jnp.asarray(v),
                             chain.base_from_laser(jnp.float32(a)),
                             jnp.zeros((cfg.line_capacity,), jnp.float32))
        if bool(agg.ready(state)):
            cloud, state = agg.emit(state)
            clouds.append(cloud)
    return clouds


def test_loopback_stream_equals_reference_aggregation():
    from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.registration.ndt import NDTParams

    world = syn.default_office()
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"),
                       encoder_offset=0.0)
    T_wb = np.eye(4)
    T_wb[2, 3] = 1.0
    n_beams, n_lines = 271, 140
    cap = syn.simulate_rotating_capture(
        world, chain, T_wb, n_lines=n_lines, sweep_rad=1.25 * math.pi,
        n_beams=n_beams, fov_deg=270.0)
    ranges = np.linalg.norm(cap.line_points, axis=2) * cap.line_valid
    telegrams = _telegrams(ranges, 270.0 / (n_beams - 1))

    slam = SLAMSystem(SLAMConfig(odometry=OdometryConfig(
        scan_capacity=4096, downsample_leaf=0.3, map_leaf=0.5,
        map_half_extent=16.0, map_capacity=16384,
        ndt=NDTParams(max_iterations=15))), device="cpu")
    cfg = LiveConfig(sensor_model="LMS100", start_angle_deg=-135.0,
                     range_min=0.05,
                     aggregator=AggregatorConfig(
                         capacity=65536, line_length=1024,
                         angular_threshold=1.1 * math.pi))
    pipe = LivePipeline(cfg, chain=chain, slam=slam)
    assert pipe.device.type == "cpu"
    # gated: a fake paced at 4 ms a line outran the consumer's feeder (128
    # lines) when other processes shared the CPU, and lines were dropped
    results = _run(pipe, telegrams, cs.counter_source(cap.encoder_angles),
                   0.004, gated=True, max_scans=1)
    assert len(results) == 1 and pipe.dropped_lines == 0
    cloud, metrics = results[0]
    assert metrics is not None and pipe.slam_state.n_keyframes == 1
    np.testing.assert_allclose(pipe.slam_state.odom.pose.numpy(), np.eye(4),
                               atol=1e-5)

    ref = _reference_clouds(telegrams, cap.encoder_angles, cfg, 0.0)[0]
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(cloud.points.numpy(), np.asarray(ref.points),
                               atol=1e-5)
    assert int(cloud.mask.sum()) > 5000
    # every point sits on a directly transformed capture point (the wire's
    # mm quantization)
    agg = cloud.points[cloud.mask].numpy()
    direct = np.concatenate([
        (cap.line_points[i] @ cap.line_transforms[i][:3, :3].T
         + cap.line_transforms[i][:3, 3])[cap.line_valid[i]]
        for i in range(n_lines)])
    sample = agg[:: max(1, len(agg) // 200)]
    d = np.linalg.norm(sample[:, None, :] - direct[None, :, :], axis=2)
    assert d.min(axis=1).max() < 5e-3


def test_interpolated_angles_match_profile():
    """Every line's angle matches the true profile at the line's arrival
    within one encoder tick on average, a few at worst (scheduling)."""
    n_beams, n_lines = 91, 60
    telegrams = _telegrams(np.full((n_lines, n_beams), 3.0),
                           270.0 / (n_beams - 1))
    w = 2.0                          # rad/s unit rotation
    t0 = time.monotonic()

    def angle_source():
        return -(w * (time.monotonic() - t0) % (2 * math.pi))

    cfg = LiveConfig(sensor_model="LMS100", start_angle_deg=-135.0,
                     range_min=0.05, line_capacity=1024,
                     aggregator=AggregatorConfig(capacity=65536,
                                                 line_length=1024))
    pipe = LivePipeline(cfg, device="cpu")
    _run(pipe, telegrams, angle_source, 0.004, max_scans=None,
         max_lines=n_lines, encoder_rate_hz=500.0)
    assert len(pipe.line_angles) >= n_lines - 2
    errs = []
    for t_arr, a in pipe.line_angles:
        d = (a - (-w * (t_arr - t0))) % (2 * math.pi)
        errs.append(min(d, 2 * math.pi - d))
    assert float(np.mean(errs)) < TICK, np.mean(errs)
    assert float(np.max(errs)) < 8 * TICK, np.max(errs)


def test_front_laser_equals_reference_chain():
    from tpu_slam.ingest.frames import SensorModel as JSensor
    from tpu_slam.ingest.frames import front_laser_transform

    n_beams = 181
    ranges = np.random.default_rng(3).uniform(0.5, 20.0, (6, n_beams))
    telegrams = _telegrams(ranges, 270.0 / (n_beams - 1))
    pipe = LivePipeline(LiveConfig(sensor_model="LMS100",
                                   start_angle_deg=-135.0, range_min=0.05),
                        device="cpu")
    got = []
    dev = cs.FakeLms(telegrams, period_s=0.0)
    lms = NativeLms(cap=1024)
    try:
        lms.connect("127.0.0.1", dev.port)
        lms.start_scan()
        n = pipe.run_front(lms, lambda p, v, t: got.append((p, v, t)),
                           max_lines=6)
    finally:
        lms.close()
        dev.join()
    assert n == 6 and len(got) == 6
    T = np.asarray(front_laser_transform(JSensor.by_name("LMS100")))
    ang = np.radians(-135.0) + np.radians(270.0 / (n_beams - 1)) \
        * np.arange(n_beams)
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_beams)], 1)
    for (pts, valid, _), r in zip(got, ranges):
        assert valid.all()
        expect = (dirs * r[:, None]) @ T[:3, :3].T + T[:3, 3]
        np.testing.assert_allclose(pts, expect, atol=2e-3)  # mm on the wire


def test_refuses_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LivePipeline(LiveConfig())
    assert LivePipeline(LiveConfig(), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        LivePipeline(LiveConfig(line_capacity=512))
