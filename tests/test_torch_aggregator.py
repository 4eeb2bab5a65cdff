"""The port's ScanAggregator and pointcloud filters against tpu_slam's (CPU).

Seeded line streams through both aggregators, compared after every line:
masks, write_idx, dropped, the ready flag and so the emitting line
exactly; points and intensities within 1e-6. The streams hit the
exclusion box, overflow the capacity inside a scan, run disarmed
(``auto_rearm=False``) until a ``request``, and cross the 1.1 pi trigger.

Named divergence, ``angular_distance``: each line adds 2 acos(|q1.q2|) of
two float32 quaternions. Near |q1.q2| = 1 the arccos turns one last-bit
difference of the dot product into 2 * 2^-24 / sin(step/2) radians (8e-6
at a 0.03 rad step), and XLA's CPU compile of the reference rounds the
quaternion's norm differently (its sum of squares as fused multiply-adds),
so the two sums part by ~1e-5 a line, not 1e-6. Both stay within that
bound a line of the exact sum of the steps, which is what the test holds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import pointcloud as jpc
from tpu_slam.ingest import aggregator as ja
from tpu_slam_torch.core import pointcloud as tpc
from tpu_slam_torch.ingest import aggregator as ta
from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

L = 64


def _stream(n, step, seed, spread=4.0):
    """n lines: points in a cube of +-spread (some inside the +-1 m box),
    80% valid, random intensities, the unit at k * step."""
    rng = np.random.default_rng(seed)
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    out = []
    for k in range(n):
        out.append((rng.uniform(-spread, spread, (L, 3)).astype(np.float32),
                    rng.random(L) < 0.8,
                    rng.random(L).astype(np.float32),
                    chain.base_from_laser(k * step).numpy()))
    return out


def _bound(step):
    """Per-line bound of the float32 angle increment's error."""
    return 4 * 2.0 ** -23 / math.sin(step / 2) + 1e-6


def _run(lines, step, requests=(), **cfg):
    """Both aggregators line by line; returns the emitting lines."""
    J = ja.ScanAggregator(ja.AggregatorConfig(line_length=L, **cfg))
    T = ta.ScanAggregator(ta.AggregatorConfig(line_length=L, **cfg),
                          device="cpu")
    C = T.config.capacity
    js, ts = J.init_state(), T.init_state()
    emits, n_inc, exact = [], 0, 0.0
    prev = None
    for k, (p, v, i, M) in enumerate(lines):
        if k in requests:
            js, ts = J.request(js), T.request(ts)
        armed = bool(ts.creating)
        js = J.add_line(js, jnp.asarray(p), jnp.asarray(v), jnp.asarray(M),
                        jnp.asarray(i))
        ts = T.add_line(ts, torch.from_numpy(p), torch.from_numpy(v),
                        torch.from_numpy(M), torch.from_numpy(i))
        assert bool(ts.creating) == bool(js.creating)
        assert int(ts.write_idx) == int(js.write_idx), k
        assert int(ts.dropped) == int(js.dropped), k
        np.testing.assert_array_equal(ts.mask[:C].numpy(),
                                      np.asarray(js.mask))
        np.testing.assert_allclose(ts.points[:C].numpy(),
                                   np.asarray(js.points), atol=1e-6)
        np.testing.assert_array_equal(ts.intensity[:C].numpy(),
                                      np.asarray(js.intensity))
        if armed and prev is not None:
            n_inc += 1
            exact += step
        prev = k if armed else prev
        tol = n_inc * _bound(step)
        assert abs(float(ts.angular_distance) - exact) <= tol, k
        assert abs(float(js.angular_distance) - exact) <= tol, k
        # progress is 0.1 % steps of the sweep: one step apart at most
        assert abs(float(T.progress(ts)) - float(J.progress(js))) <= 0.1001
        ready = bool(T.ready(ts))
        assert ready == bool(J.ready(js)), k
        if ready:
            emits.append(k)
            jc, js = J.emit(js)
            tc, ts = T.emit(ts)
            np.testing.assert_array_equal(tc.mask.numpy(),
                                          np.asarray(jc.mask))
            np.testing.assert_allclose(tc.points.numpy(),
                                       np.asarray(jc.points), atol=1e-6)
            np.testing.assert_array_equal(tc.attrs.numpy(),
                                          np.asarray(jc.attrs))
            n_inc, exact, prev = 0, 0.0, None
    return emits, T, ts


def test_trigger_box_and_overflow():
    """1.1 pi at 0.05 rad a line: an emit every 71 lines (the first line
    latches); 2,000 slots overflow inside each scan."""
    step = 0.05
    emits, T, ts = _run(_stream(160, step, seed=0), step, capacity=2000)
    n = math.ceil(1.1 * math.pi / step)
    assert emits == [n, 2 * n + 1]
    assert int(ts.dropped) == 0 and int(ts.write_idx) > 0


def test_overflow_counts_every_dropped_point():
    step = 0.03
    lines = _stream(40, step, seed=1)
    emits, T, ts = _run(lines, step, capacity=1000)
    assert emits == []
    kept = 0
    for p, v, i, M in lines:
        q = p @ M[:3, :3].T + M[:3, 3]
        kept += int((v & ~(np.abs(q) <= 1.0).all(1)).sum())
    assert int(ts.write_idx) == 1000
    assert int(ts.dropped) == kept - 1000 > 0


def test_exclusion_box_keeps_only_outside_points():
    step = 0.04
    lines = _stream(30, step, seed=2, spread=1.5)
    _, T, ts = _run(lines, step, capacity=4096, bb_x_up=0.5, bb_y_up=0.5,
                    bb_z_down=-0.5)
    pts = ts.points[:int(ts.write_idx)].numpy()
    inside = ((pts[:, 0] <= 0.5) & (pts[:, 0] >= -1) & (pts[:, 1] <= 0.5)
              & (pts[:, 1] >= -1) & (pts[:, 2] <= 1) & (pts[:, 2] >= -0.5))
    assert not inside.any() and len(pts) > 100


def test_disarmed_until_request():
    """auto_rearm=False: after the first emit nothing is kept and the sweep
    stays at 0 (progress -1) until a request re-arms the aggregator."""
    step = 0.06
    lines = _stream(150, step, seed=3)
    emits, T, ts = _run(lines, step, requests=(90,), capacity=8192,
                        auto_rearm=False)
    n = math.ceil(1.1 * math.pi / step)
    assert emits == [n, 90 + n]
    assert not bool(ts.creating) and float(T.progress(ts)) == -1.0


def test_armed_false_state_and_emit_gives_the_buffers_away():
    T = ta.ScanAggregator(ta.AggregatorConfig(capacity=256, line_length=L),
                          device="cpu")
    s = T.init_state(armed=False)
    p, v, i, M = _stream(1, 0.1, seed=4)[0]
    s = T.add_line(s, torch.from_numpy(p), torch.from_numpy(v),
                   torch.from_numpy(M), torch.from_numpy(i))
    assert int(s.write_idx) == 0 and float(T.progress(s)) == -1.0
    s = T.request(s)
    s = T.add_line(s, torch.from_numpy(p), torch.from_numpy(v),
                   torch.from_numpy(M), torch.from_numpy(i))
    cloud, s2 = T.emit(s)
    before = cloud.points.clone()
    s2 = T.add_line(s2, torch.from_numpy(p), torch.from_numpy(v),
                    torch.from_numpy(M), torch.from_numpy(i))
    assert torch.equal(cloud.points, before)        # the cloud is its own
    assert cloud.capacity == 256 and int(cloud.mask.sum()) > 0


def _clouds(seed=0, n=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.7
    attrs = rng.random((n, 2)).astype(np.float32)
    pts = np.where(mask[:, None], pts, jpc.PAD_COORD).astype(np.float32)
    j = jpc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask),
                       attrs=jnp.asarray(attrs))
    t = tpc.PointCloud(points=torch.from_numpy(pts),
                       mask=torch.from_numpy(mask),
                       attrs=torch.from_numpy(attrs))
    return j, t


def _same(t, j):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    if j.attrs is None:
        assert t.attrs is None
    else:
        np.testing.assert_array_equal(t.attrs.numpy(), np.asarray(j.attrs))


@pytest.mark.parametrize("origin", [None, (0.5, -0.25, 0.1)])
def test_pointcloud_filters_equal_reference(origin):
    j, t = _clouds()
    lo, hi = (-1.0, -0.5, -2.0), (1.5, 0.5, 0.25)
    _same(tpc.exclusion_box_filter(t, lo, hi),
          jpc.exclusion_box_filter(j, jnp.asarray(lo), jnp.asarray(hi)))
    _same(tpc.range_filter(t, 0.8, 2.5, origin=origin),
          jpc.range_filter(j, 0.8, 2.5, origin=None if origin is None
                           else jnp.asarray(origin)))
    keep = np.random.default_rng(1).random(300) < 0.5
    _same(t.filter(torch.from_numpy(keep)), j.filter(jnp.asarray(keep)))
    j2, t2 = _clouds(seed=2, n=50)
    _same(tpc.merge(t, t2), jpc.merge(j, j2))
    bare_t = tpc.PointCloud(points=t2.points, mask=t2.mask)
    bare_j = jpc.PointCloud(points=j2.points, mask=j2.mask)
    _same(tpc.merge(t, bare_t), jpc.merge(j, bare_j))
