"""The port's copy of tpu_slam's CoLa-A telegram code (CPU, numpy).

Framing, parse and format held against the original: the same bytes from
``format_telegram`` (single and multi-echo, RSSI, negative start angles,
the scale factor), the same frames and remainder from ``extract_frames``
on a stream cut at every byte, the same fields from ``parse_telegram``,
and the same LaserScan and points (exactly: the same numpy code).
"""

import dataclasses

import numpy as np
import pytest

from tpu_slam.ingest import sick_cola as jsc
from tpu_slam_torch.ingest import sick_cola as sc


def _cases():
    rng = np.random.default_rng(0)
    n = 541
    one = rng.integers(0, 60000, n).astype(np.uint32)
    rssi = rng.integers(0, 255, n).astype(np.uint32)
    three = [rng.integers(20, 60000, 271).astype(np.uint32)
             for _ in range(3)]
    return [
        dict(ranges_mm=one),
        dict(ranges_mm=one, rssi=rssi, scale_factor=2.0,
             start_angle_deg=-135.0, ang_step_deg=0.5, scan_no=42),
        dict(ranges_mm=three, rssi=list(three), start_angle_deg=-45.0,
             ang_step_deg=0.25, scan_no=7, scan_frequency_hz=25.0),
        dict(ranges_mm=one[:181], start_angle_deg=-90.0, ang_step_deg=1.0,
             scan_no=0xFFFF),
    ]


@pytest.mark.parametrize("case", range(4))
def test_format_and_parse_equal_reference(case):
    kw = _cases()[case]
    raw = sc.format_telegram(**kw)
    assert raw == jsc.format_telegram(**kw)
    payload = sc.extract_frames(raw)[0][0]
    got, ref = sc.parse_telegram(payload), jsc.parse_telegram(payload)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name in ("dist_channels", "rssi_channels"):
            assert len(a) == len(b)
            for ca, cb in zip(a, b):
                for g in dataclasses.fields(cb):
                    np.testing.assert_array_equal(getattr(ca, g.name),
                                                  getattr(cb, g.name))
        else:
            assert a == b, f.name
    for invert in (False, True):
        s = sc.telegram_to_laser_scan(got, start_angle_deg=-135.0,
                                      invert=invert, stamp=1.5)
        r = jsc.telegram_to_laser_scan(ref, start_angle_deg=-135.0,
                                       invert=invert, stamp=1.5)
        for f in dataclasses.fields(r):
            a, b = getattr(s, f.name), getattr(r, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
        for a, b in zip(sc.laser_scan_to_points(s),
                        jsc.laser_scan_to_points(r)):
            np.testing.assert_array_equal(a, b)


def test_frames_of_a_cut_stream_equal_reference():
    stream = (b"junk" + sc.format_telegram(np.arange(30), scan_no=1)
              + sc.format_telegram(np.arange(5), scan_no=2) + b"\x02part")
    for cut in range(len(stream) + 1):
        for part in (stream[:cut], stream[cut:]):
            assert sc.extract_frames(part) == jsc.extract_frames(part)


def test_rejects_what_the_reference_rejects():
    bad = [b"sSN NotAScan 1 2 3", b"short",
           b"sSN LMDscandata " + b"0 " * 17 + b"1 DIST1 3F800000 0 0 1388 5 1",
           ]
    for payload in bad:
        with pytest.raises(ValueError):
            jsc.parse_telegram(payload)
        with pytest.raises(ValueError):
            sc.parse_telegram(payload)
    with pytest.raises(ValueError):
        sc.format_telegram([np.zeros(3)] * 6)
    tg = sc.parse_telegram(sc.extract_frames(
        sc.format_telegram(np.arange(3)))[0][0])
    with pytest.raises(ValueError):
        sc.telegram_to_laser_scan(dataclasses.replace(tg, dist_channels=[]))
