"""The port's binding of the native runtime against tpu_slam's (CPU).

The port builds ``native/src`` with g++ into ``tpu_slam_torch/_build/`` at
first use and raises if it cannot: nothing here skips for a missing
library. Each case runs the port's binding and the reference's
(``native/build``, which the tests' conftest builds) on the same inputs:
single- and multi-echo parse (meta and arrays bit-equal), garbage
rejected, the TCP scanner client on a fake scanner that cuts every
telegram in two, the motor controller's sp/gp protocol, the feeder's
round trip, overflow and cross-thread order, and the VLP-16 decoder
against the port's Python decoder.
"""

import threading
import time

import numpy as np
import pytest

import chip_smoke as cs
from tpu_slam.ingest import native as jnat
from tpu_slam_torch.ingest import native as nat
from tpu_slam_torch.ingest import sick_cola as sc

META = [f[0] for f in nat.ScanMeta._fields_]


@pytest.fixture(scope="module")
def jlib():
    lib = jnat.load()
    assert lib is not None, "the reference's native/build library is missing"
    return lib


def test_library_is_built_from_the_sources_and_loads():
    path = nat.library_path()
    assert nat.load() is not None and path.exists()
    assert path.parent == nat.BUILD_DIR and "native" not in path.parent.name
    assert nat.library_path() == path          # same sources, same name


def _same_meta(a, b):
    for name in META:
        assert getattr(a, name) == getattr(b, name), name


def test_parse_equals_reference(jlib):
    rng = np.random.default_rng(0)
    raw = sc.format_telegram(rng.integers(20, 60000, 541).astype(np.uint32),
                             rssi=rng.integers(0, 255, 541).astype(np.uint32),
                             scale_factor=2.0, start_angle_deg=-135.0,
                             ang_step_deg=0.5, scan_no=42)
    payload = sc.extract_frames(raw)[0][0]
    got, ref = nat.parse_telegram_native(payload), \
        jnat.parse_telegram_native(payload)
    _same_meta(got[0], ref[0])
    assert got[0].scan_no == 42 and got[0].n_dist == 541
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    # and the Python parser's ranges within 1e-6 (mm * 0.001 * scale)
    py = sc.telegram_to_laser_scan(sc.parse_telegram(payload))
    np.testing.assert_allclose(got[1], py.ranges, rtol=1e-6)


def test_multi_echo_parse_equals_reference(jlib):
    rng = np.random.default_rng(1)
    dists = [rng.integers(20, 60000, 271).astype(np.uint32) for _ in range(3)]
    rssis = [rng.integers(0, 255, 271).astype(np.uint32) for _ in range(3)]
    for kw in (dict(ranges_mm=dists, rssi=rssis, scale_factor=2.0),
               dict(ranges_mm=dists[0], rssi=rssis[0])):
        payload = sc.extract_frames(sc.format_telegram(**kw))[0][0]
        got = nat.parse_telegram_native_multi(payload)
        ref = jnat.parse_telegram_native_multi(payload)
        _same_meta(got[0], ref[0])
        for a, b in zip(got[1:], ref[1:]):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_garbage_is_rejected(jlib):
    for bad in (b"sSN NotAScan 1 2 3", b"short", b""):
        with pytest.raises(ValueError):
            jnat.parse_telegram_native(bad)
        with pytest.raises(ValueError):
            nat.parse_telegram_native(bad)
        with pytest.raises(ValueError):
            nat.parse_telegram_native_multi(bad)


def _stream(client_cls, telegrams):
    dev = cs.FakeLms(telegrams, period_s=0.002)
    cli = client_cls(cap=1024)
    try:
        cli.connect("127.0.0.1", dev.port)
        cli.start_scan()
        out = []
        while (o := cli.poll(timeout_ms=2000)) is not None:
            out.append(o)
    except ConnectionError:
        pass                  # the device closed: the stream is over
    finally:
        cli.close()
        dev.join()
    return out


def test_lms_client_equals_reference(jlib):
    """Five telegrams, each cut in two on the wire (reassembly)."""
    rng = np.random.default_rng(2)
    chunks = []
    for k in range(5):
        raw = sc.format_telegram(rng.integers(100, 20000, 181), scan_no=k)
        chunks += [raw[:50], raw[50:]]
    got = _stream(nat.NativeLms, chunks)
    ref = _stream(jnat.NativeLms, chunks)
    assert [m.scan_no for m, _, _ in got] == list(range(5))
    assert len(got) == len(ref) == 5
    for (ma, ra, ia), (mb, rb, ib) in zip(got, ref):
        _same_meta(ma, mb)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ia, ib)


def _m3d_exchange(client_cls):
    dev = cs.FakeM3d(ticks=lambda k: 7500)
    cli = client_cls()
    try:
        cli.connect_tcp("127.0.0.1", dev.port)
        res, angle = cli.encoder_res(), cli.angle()
        cli.set_speed(12)
        cli.set_position(np.pi, 10, relative=False)
        cli.set_homing_offset(1234)
        cli.write_param(0x3000, 0x1, 0)
        val = cli.get_param(0x3000, 0x10)
    finally:
        cli.close()
        dev.join()
    return res, angle, val, dev.writes


def test_m3d_protocol_equals_reference(jlib):
    got, ref = _m3d_exchange(nat.NativeM3d), _m3d_exchange(jnat.NativeM3d)
    assert got == ref
    res, angle, val, writes = got
    assert res == 10000 and angle == pytest.approx(-2 * np.pi * 0.75)
    assert val == 10
    # velocity mode, speed, stop, start (driverLib.cpp:242-261), then the
    # absolute position move and the homing offset + EEPROM save
    assert writes[:4] == [(0x3003, 0x0, 3), (0x3000, 0x10, 12),
                          (0x3000, 0x1, 0), (0x3000, 0x1, 49)]
    assert writes[4:9] == [(0x3003, 0x0, 7), (0x3000, 0x10, 10),
                           (0x3000, 0x11, 5000), (0x3000, 0x1, 0),
                           (0x3000, 0x1, 52)]
    assert writes[9:] == [(0x37B3, 0x0, 1234), (0x1010, 0x1, 0x65766173),
                          (0x3000, 0x1, 0)]


def test_m3d_refuses_without_a_device():
    cli = nat.NativeM3d()
    try:
        with pytest.raises(ConnectionError):
            cli.angle()
        with pytest.raises(ConnectionError):
            cli.connect_tcp("127.0.0.1", 1, timeout_ms=200)
    finally:
        cli.close()


def _feeder_round(cls):
    f = cls(n_slots=4, line_cap=64)
    try:
        pushed = [f.push(np.full(32, float(k), np.float32),
                         np.full(32, 0.5 * k, np.float32) if k % 2 else None,
                         stamp=float(k), angle=0.1 * k) for k in range(5)]
        state = (f.dropped, f.depth)
        popped = [f.pop(timeout_ms=100) for _ in range(4)]
        empty = f.pop(timeout_ms=50)
    finally:
        f.close()
    return pushed, state, popped, empty


def test_feeder_round_trip_and_overflow_equal_reference(jlib):
    got, ref = _feeder_round(nat.NativeFeeder), \
        _feeder_round(jnat.NativeFeeder)
    assert got[0] == ref[0] == [True] * 4 + [False]
    assert got[1] == ref[1] == (1, 4)
    assert got[3] is None and ref[3] is None
    for a, b in zip(got[2], ref[2]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert [p[2] for p in got[2]] == [0.0, 1.0, 2.0, 3.0]


def test_feeder_keeps_order_across_threads():
    f = nat.NativeFeeder(n_slots=16, line_cap=128)
    n_lines = 200

    def producer():
        for k in range(n_lines):
            while not f.push(np.full(100, float(k), np.float32), None,
                             float(k), 0.0):
                time.sleep(0.0005)

    t = threading.Thread(target=producer)
    t.start()
    try:
        received = []
        while len(received) < n_lines:
            out = f.pop(timeout_ms=2000)
            assert out is not None
            received.append(out[2])
    finally:
        t.join(timeout=10)
        f.close()
    assert not t.is_alive()
    assert received == [float(k) for k in range(n_lines)]


def test_vlp16_decode_equals_python_decoder():
    from tpu_slam_torch.ingest import velodyne as vlp

    rng = np.random.default_rng(7)
    S = 120
    az = np.linspace(350.0, 350.0 + 0.199 * S, S) % 360.0  # crosses wrap
    dist = rng.uniform(0.1, 140.0, (S, 16))                # some out of gate
    dist[rng.uniform(size=(S, 16)) < 0.15] = 0.0
    inten = rng.integers(0, 256, (S, 16)).astype(float)
    pkts = vlp.encode_packets(az, dist, inten, start_time_s=3.25)
    py = vlp.sequences_to_points(vlp.parse_packet_batch(pkts),
                                 min_range=0.4, max_range=130.0)
    na = nat.vlp16_decode_native(pkts, min_range=0.4, max_range=130.0)
    assert na[0].shape == py[0].shape
    np.testing.assert_allclose(na[0], py[0], atol=1e-5)
    np.testing.assert_array_equal(na[1], py[1])
    np.testing.assert_array_equal(na[2], py[2])
    np.testing.assert_allclose(na[3], py[3], atol=1e-6)
    np.testing.assert_allclose(na[4], py[4], atol=1e-9)
    bad = pkts.copy()
    bad[0, 200] = 0x00
    with pytest.raises(ValueError):
        nat.vlp16_decode_native(bad)
