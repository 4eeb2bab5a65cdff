"""SICK CoLa-A ``LMDscandata`` telegram parsing — pure functions, host-side.

A copy of ``tpu_slam.ingest.sick_cola`` (numpy only; the port keeps its
own so that it imports nothing of ``tpu_slam``). It re-implements the
observable behaviour of the reference's minimal SICK driver
(m3d/sick_minimal_driver/src/lms_mini_lib.cpp:140-261 header/channel
parse, src/lms_poller.cpp:65-121 LaserScan construction) as pure
functions with no sockets, shared by the live TCP poller (the native
library) and offline replay.

Wire format (CoLa-A, ASCII): each telegram is framed by STX (0x02) / ETX
(0x03); the payload is space-separated tokens. For ``sRA/sSN LMDscandata``
the header carries version, device, serial, status, counters, frequencies
and encoder info as hex integers; each measurement channel block is
``<label> <scale:hexfloat> <offset:hexfloat> <start_angle:1e-4 deg>
<step:1e-4 deg> <count> <count x hex values>``.

Behavioural invariants of the reference:
  * range scaling is ``0.001 * scale_factor`` (device mm -> meters),
  * intensities are scaled by 0.01 when fed to the aggregator,
  * optional beam inversion reverses the range array,
  * LaserScan angle_min = start_angle, angle_max = -start_angle (the
    symmetric-FOV convention of lms_poller.cpp:74-100).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

STX = b"\x02"
ETX = b"\x03"

DIST_LABELS = ("DIST1", "DIST2", "DIST3", "DIST4", "DIST5")
RSSI_LABELS = ("RSSI1", "RSSI2", "RSSI3", "RSSI4", "RSSI5")


@dataclasses.dataclass
class Channel:
    """One measurement channel of a telegram (distances or intensities)."""

    label: str
    scale_factor: float        # multiplier on raw counts (typically 1.0 or 2.0)
    scale_offset: float
    start_angle_deg: float     # device convention: 1e-4 deg units on the wire
    ang_step_deg: float
    data: np.ndarray           # (N,) uint32 raw counts


@dataclasses.dataclass
class ScanTelegram:
    """Parsed LMDscandata telegram."""

    command_type: str          # "sRA" (reply) or "sSN" (stream)
    command: str               # "LMDscandata"
    version: int
    device_no: int
    serial_no: int
    device_status: int
    telegram_no: int
    scan_no: int
    time_since_startup_us: int
    time_of_transmission_us: int
    scan_frequency_hz: float   # wire unit: 1/100 Hz
    measurement_frequency_hz: float
    dist_channels: List[Channel]
    rssi_channels: List[Channel]


@dataclasses.dataclass
class LaserScan:
    """ROS-free sensor_msgs/LaserScan equivalent (all angles radians)."""

    angle_min: float
    angle_max: float
    angle_increment: float
    range_min: float
    range_max: float
    ranges: np.ndarray               # (N,) float32 meters
    intensities: Optional[np.ndarray]  # (N,) float32 or None
    stamp: float = 0.0
    frame_id: str = ""


def _hex_int(tok: str) -> int:
    """Parse a hex token; device encodes signed values as two's complement."""
    v = int(tok, 16)
    nbits = 4 * len(tok)
    if nbits <= 32 and v >= 1 << (nbits - 1):
        v -= 1 << nbits
    return v


def _hex_uint(tok: str) -> int:
    return int(tok, 16)


def _hex_float(tok: str) -> float:
    """IEEE-754 bits in hex -> float (ref lms_mini_lib.cpp:131-139)."""
    return struct.unpack(">f", _hex_uint(tok).to_bytes(4, "big"))[0]


def extract_frames(buffer: bytes) -> tuple[List[bytes], bytes]:
    """Split a raw byte stream into complete STX..ETX frames.

    Returns (payloads, remainder). Bytes before the first STX are discarded
    (resync after partial reads, the reference's framing loop
    lms_mini_lib.cpp:55-83). The remainder holds a trailing partial frame.
    """
    frames: List[bytes] = []
    while True:
        start = buffer.find(STX)
        if start < 0:
            return frames, b""
        end = buffer.find(ETX, start + 1)
        if end < 0:
            return frames, buffer[start:]
        frames.append(buffer[start + 1:end])
        buffer = buffer[end + 1:]


def _parse_channel(tokens: Sequence[str], offset: int) -> Channel:
    label = tokens[offset]
    scale = _hex_float(tokens[offset + 1])
    scale_off = _hex_float(tokens[offset + 2])
    start_angle = 1e-4 * _hex_int(tokens[offset + 3])
    step = 1e-4 * _hex_uint(tokens[offset + 4])
    n = _hex_uint(tokens[offset + 5])
    if offset + 6 + n > len(tokens):
        raise ValueError(
            f"channel {label} claims {n} samples but telegram has only "
            f"{len(tokens) - offset - 6} tokens left")
    data = np.array([_hex_uint(t) for t in tokens[offset + 6:offset + 6 + n]],
                    dtype=np.uint32)
    return Channel(label=label, scale_factor=scale, scale_offset=scale_off,
                   start_angle_deg=start_angle, ang_step_deg=step, data=data)


def parse_telegram(payload: bytes | str) -> ScanTelegram:
    """Parse one LMDscandata telegram payload (no STX/ETX framing bytes).

    Channel blocks are located by label search, so devices that emit extra
    header fields (encoder blocks, different field counts) still parse — the
    same robustness the reference gets from its phrase search
    (lms_mini_lib.cpp:112-125 searchForPhase).
    """
    text = payload.decode("ascii", "replace") if isinstance(payload, bytes) else payload
    tokens = text.split()
    if len(tokens) < 19:
        raise ValueError(f"telegram too short: {len(tokens)} tokens")
    if tokens[1] != "LMDscandata":
        raise ValueError(f"not an LMDscandata telegram: {tokens[:2]}")

    n_encoders = _hex_uint(tokens[18])

    def find_label(label: str) -> int:
        try:
            return tokens.index(label)
        except ValueError:
            return -1

    dist_channels = []
    for lbl in DIST_LABELS:
        off = find_label(lbl)
        if off >= 0:
            dist_channels.append(_parse_channel(tokens, off))
    rssi_channels = []
    for lbl in RSSI_LABELS:
        off = find_label(lbl)
        if off >= 0:
            rssi_channels.append(_parse_channel(tokens, off))

    return ScanTelegram(
        command_type=tokens[0],
        command=tokens[1],
        version=_hex_uint(tokens[2]),
        device_no=_hex_uint(tokens[3]),
        serial_no=_hex_uint(tokens[4]),
        device_status=_hex_uint(tokens[6]),
        telegram_no=_hex_uint(tokens[7]),
        scan_no=_hex_uint(tokens[8]),
        time_since_startup_us=_hex_uint(tokens[9]),
        time_of_transmission_us=_hex_uint(tokens[10]),
        scan_frequency_hz=0.01 * _hex_uint(tokens[16]),
        measurement_frequency_hz=100.0 * _hex_uint(tokens[17]),
        dist_channels=dist_channels,
        rssi_channels=rssi_channels,
    )


def telegram_to_laser_scan(tg: ScanTelegram,
                           start_angle_deg: float = -45.0,
                           invert: bool = False,
                           range_min: float = 0.0,
                           range_max: float = 100.0,
                           stamp: float = 0.0,
                           frame_id: str = "") -> LaserScan:
    """First-echo telegram -> LaserScan, reproducing lms_poller.cpp:65-121.

    ``start_angle_deg`` overrides the device-reported start angle, matching
    the reference's startAngle ROS param; angle_max is its negation
    (symmetric FOV). Ranges scale by 0.001 * channel scale factor (mm -> m).
    ``invert`` reverses the beam order (mirror-mounted scanners).
    """
    if not tg.dist_channels:
        raise ValueError("telegram has no DIST channels")
    dist = tg.dist_channels[0]
    scale = 0.001 * dist.scale_factor
    ranges = (dist.data.astype(np.float32) * np.float32(scale))
    intensities = None
    if tg.rssi_channels:
        intensities = tg.rssi_channels[0].data.astype(np.float32)
    if invert:
        ranges = ranges[::-1].copy()
        if intensities is not None:
            intensities = intensities[::-1].copy()
    return LaserScan(
        angle_min=math.radians(start_angle_deg),
        angle_max=math.radians(-start_angle_deg),
        angle_increment=math.radians(dist.ang_step_deg),
        range_min=range_min,
        range_max=range_max,
        ranges=ranges,
        intensities=intensities,
        stamp=stamp,
        frame_id=frame_id,
    )


def laser_scan_to_points(scan: LaserScan) -> tuple[np.ndarray, np.ndarray]:
    """Polar -> planar cartesian points in the laser frame.

    Reproduces the aggregator's beam expansion (m3d_aggregator.cpp:269-286):
    x = cos(angle) * r, y = sin(angle) * r, z = 0, intensity scaled by 0.01.

    Returns (points (N, 3) float32, intensities (N,) float32).
    """
    n = scan.ranges.shape[0]
    ang = scan.angle_min + np.arange(n, dtype=np.float32) * scan.angle_increment
    pts = np.stack([
        np.cos(ang) * scan.ranges,
        np.sin(ang) * scan.ranges,
        np.zeros(n, dtype=np.float32),
    ], axis=1).astype(np.float32)
    if scan.intensities is not None and scan.intensities.shape[0] == n:
        inten = 0.01 * scan.intensities.astype(np.float32)
    else:
        inten = np.zeros(n, dtype=np.float32)
    return pts, inten


def format_telegram(ranges_mm: np.ndarray | Sequence[np.ndarray],
                    rssi: Optional[np.ndarray | Sequence[np.ndarray]] = None,
                    scale_factor: float = 1.0,
                    start_angle_deg: float = -45.0,
                    ang_step_deg: float = 0.5,
                    scan_no: int = 0,
                    scan_frequency_hz: float = 50.0) -> bytes:
    """Encode an LMDscandata telegram (inverse of parse — simulator/tests).

    Produces the framed STX..ETX byte string a real LMS-1xx would emit for
    one scan; used by golden tests and the device simulator. ``ranges_mm``
    (and ``rssi``) may be a single (N,) array — first echo only — or a
    sequence of up to 5 arrays, one per echo: the device emits DIST1..5 /
    RSSI1..5 channel blocks in multi-echo mode
    (lms_mini_lib.cpp:170-208 procesChannel per label).
    """
    def hx(v: int) -> str:
        return format(v & 0xFFFFFFFF, "X")

    dists = ([np.asarray(r) for r in ranges_mm]
             if isinstance(ranges_mm, (list, tuple))
             else [np.asarray(ranges_mm)])
    rssis = ([] if rssi is None
             else [np.asarray(r) for r in rssi]
             if isinstance(rssi, (list, tuple)) else [np.asarray(rssi)])
    if len(dists) > 5 or len(rssis) > 5:
        raise ValueError("at most 5 echo channels (DIST1..5/RSSI1..5)")

    scale_hex = format(struct.unpack(">I", struct.pack(">f", scale_factor))[0], "X")
    sa_hex = hx(int(start_angle_deg * 10000) & 0xFFFFFFFF)
    step_hex = format(int(ang_step_deg * 10000), "X")
    toks = [
        "sSN", "LMDscandata", "1", "1", hx(12345678),
        "0", "0",                       # device status
        hx(scan_no), hx(scan_no),       # telegram no, scan no
        hx(1000), hx(2000),             # timestamps
        "0", "0", "0", "0",             # input/output status
        "0",                            # reserved
        hx(int(scan_frequency_hz * 100)),
        hx(int(scan_frequency_hz * len(dists[0]) / 100)),
        "0",                            # no encoders
        hx(len(dists)),                 # 16-bit channel count
    ]
    for e, r in enumerate(dists):
        toks += [f"DIST{e + 1}", scale_hex, "00000000", sa_hex, step_hex,
                 hx(len(r))] + [format(int(v) & 0xFFFFFFFF, "X") for v in r]
    if rssis:
        toks += [hx(len(rssis))]        # 8-bit channel count
        for e, r in enumerate(rssis):
            toks += [f"RSSI{e + 1}", "3F800000", "00000000", sa_hex,
                     step_hex, hx(len(r))] + [
                         format(int(v) & 0xFFFFFFFF, "X") for v in r]
    return STX + " ".join(toks).encode("ascii") + ETX
