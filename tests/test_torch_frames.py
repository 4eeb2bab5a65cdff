"""The port's frame chain of the rotating unit against tpu_slam's (CPU).

base_from_laser for one angle and for a batch, every sensor model's
mount, the front laser and the calibration tail within 1e-6 (float32
products in another order); encoder ticks exactly; calibration files
written by either package read by the other; EncoderHistory as
tests/test_live_interp.py checks it, and equal to the reference's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.ingest import frames as jf
from tpu_slam_torch.ingest import frames as tf

TOL = 1e-6
CALIB = ((0.012, -0.02, 0.031), (0.01, 0.02, -0.03, 0.99935))


def _chains(name, offset=math.pi):
    j = jf.FrameChain(sensor=jf.SensorModel.by_name(name),
                      calibration=jf.Calibration(*CALIB),
                      encoder_offset=offset)
    t = tf.FrameChain(sensor=tf.SensorModel.by_name(name),
                      calibration=tf.Calibration(*CALIB),
                      encoder_offset=offset)
    return j, t


@pytest.mark.parametrize("name", sorted(tf.SENSOR_MODELS))
def test_base_from_laser_equals_reference(name):
    angles = np.random.default_rng(0).uniform(-8, 8, 64).astype(np.float32)
    j, t = _chains(name)
    batch = t.base_from_laser(torch.from_numpy(angles))
    assert batch.shape == (64, 4, 4) and batch.dtype == torch.float32
    np.testing.assert_allclose(
        batch.numpy(), np.asarray(j.base_from_laser(jnp.asarray(angles))),
        atol=TOL)
    for a in angles[:8]:
        one = t.base_from_laser(float(a))
        assert one.shape == (4, 4)
        np.testing.assert_allclose(
            one.numpy(), np.asarray(j.base_from_laser(jnp.float32(a))),
            atol=TOL)
    np.testing.assert_allclose(t.sensor.transform().numpy(),
                               np.asarray(j.sensor.transform()), atol=TOL)
    np.testing.assert_allclose(t.static_tail().numpy(),
                               np.asarray(j.static_tail()), atol=TOL)
    np.testing.assert_allclose(
        tf.front_laser_transform(t.sensor).numpy(),
        np.asarray(jf.front_laser_transform(j.sensor)), atol=TOL)
    with pytest.raises(KeyError):
        tf.SensorModel.by_name("LMS999")


def test_rotation_link_and_ticks_equal_reference():
    a = np.linspace(-7, 7, 57).astype(np.float32)
    np.testing.assert_allclose(
        tf.rotation_link_transform(torch.from_numpy(a)).numpy(),
        np.stack([np.asarray(jf.rotation_link_transform(jnp.float32(x)))
                  for x in a]), atol=TOL)
    ticks = np.arange(-25000, 25000, 37, dtype=np.int32)
    for res in (4096, 10000):
        np.testing.assert_array_equal(
            tf.encoder_ticks_to_angle(torch.from_numpy(ticks), res).numpy(),
            np.asarray(jf.encoder_ticks_to_angle(jnp.asarray(ticks), res)))


def test_calibration_files_cross_packages(tmp_path):
    a = str(tmp_path / "port.yaml")
    b = str(tmp_path / "ref.yaml")
    tf.Calibration(*CALIB).save(a)
    jf.Calibration(*CALIB).save(b)
    assert open(a).read() == open(b).read()
    for path in (a, b):
        jt = jf.Calibration.load(path).transform()
        tt = tf.Calibration.load(path).transform()
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=TOL)
    # absent: both create the identity file, with the same bytes
    ja, ta = str(tmp_path / "j" / "c.yaml"), str(tmp_path / "t" / "c.yaml")
    assert jf.Calibration.load(ja) == jf.Calibration()
    assert tf.Calibration.load(ta) == tf.Calibration()
    assert open(ja).read() == open(ta).read()


def test_default_path_follows_ros_home(monkeypatch, tmp_path):
    monkeypatch.setenv("ROS_HOME", str(tmp_path))
    assert tf.Calibration.default_path() == jf.Calibration.default_path() \
        == str(tmp_path / "m3d_calibration.yaml")


TICK = 2.0 * math.pi / 4096.0      # one encoder count (res 4x1024)


def test_encoder_history_interpolates_linear_ramp():
    hists = (tf.EncoderHistory(), jf.EncoderHistory())
    w = 1.5                         # rad/s
    ts = np.arange(0.0, 2.0, 0.01) + np.random.default_rng(0).uniform(
        0, 0.002, 200)
    for h in hists:
        for t in ts:
            h.push(t, -(w * t % (2 * math.pi)))
    for t in np.random.default_rng(1).uniform(0.05, 1.95, 100):
        got = hists[0].at(float(t))
        assert got == hists[1].at(float(t))
        assert abs(got - (-w * t)) < TICK
    assert len(hists[0]) == 200
    # past the newest sample: extrapolated along the last slope (<= 50 ms)
    last = ts[-1]
    for dt in (0.01, 0.2):
        assert hists[0].at(last + dt) == hists[1].at(last + dt)
        assert abs(hists[0].at(last + dt) - (-w * (last + min(dt, 0.05)))) \
            < 4 * TICK
    assert hists[0].at(-1.0) == hists[1].at(-1.0)


def test_encoder_history_unwraps_seam():
    for cls in (tf.EncoderHistory, jf.EncoderHistory):
        hist = cls()
        assert hist.newest_t() == float("-inf")
        with pytest.raises(ValueError):
            hist.at(0.0)
        hist.push(0.0, -6.2)
        hist.push(0.1, -0.05)       # wrapped past -2pi -> near 0
        assert hist.at(0.05) < -6.2
        assert hist.newest_t() == 0.1
