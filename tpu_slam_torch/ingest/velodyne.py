"""Velodyne VLP-16 packet parsing, pcap replay, and revolution assembly.

Copy of ``tpu_slam.ingest.velodyne`` (numpy only, the same code) so that
the port imports nothing of ``tpu_slam``; its tests hold what it
writes and decodes byte for byte against the original's.

The reference's outdoor workhorse is a VLP-16 driven by the external
velodyne_driver/velodyne_pointcloud nodelets with pcap replay
(m3d/m3dunit_base/launch/universal_velodyne.launch:47-81: 600 RPM, range
gate 0.4-130 m, pcap arg at :49,64). Those nodelets are out-of-repo, so
this module rebuilds the capability from the device protocol:

  * ``parse_packet_batch`` — vectorized numpy decode of raw 1206-byte data
    packets into per-firing-sequence azimuths / ranges / intensities
    (the pure-Python decoder; the reference's native C++ hot path
    is not bound by the port);
  * ``sequences_to_points`` — polar -> cartesian with the VLP-16 ring
    elevation table and per-point timing offsets (for deskew);
  * ``VelodyneStream`` — packet feed -> full-revolution clouds, cut at the
    azimuth wrap exactly like the nodelet's cut_angle=0 mode;
  * ``read_pcap`` / ``write_pcap`` — minimal libpcap-format reader/writer
    for UDP port 2368 (Ethernet II + IPv4), no external deps;
  * ``encode_packets`` — the inverse of the parser, used to synthesize
    byte-exact packet streams (and pcaps) from simulated range images so
    the whole replay path is testable end to end.

Wire format (VLP-16, single-return mode): packet = 12 data blocks x 100 B
+ 4 B timestamp (us, uint32 LE) + 2 B factory (return mode, 0x22 = VLP-16).
Block = 0xFF 0xEE flag, uint16 LE azimuth in 0.01 deg, then 32 channels of
(uint16 LE distance in 2 mm, uint8 reflectivity): the 16 lasers fired
twice. The second firing's azimuth is interpolated between block azimuths.
Firing-sequence period 55.296 us, per-channel 2.304 us.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

PACKET_SIZE = 1206
BLOCKS_PER_PACKET = 12
SEQS_PER_BLOCK = 2
SEQS_PER_PACKET = BLOCKS_PER_PACKET * SEQS_PER_BLOCK       # 24
LASERS = 16
BLOCK_FLAG = (0xFF, 0xEE)
DIST_RESOLUTION_M = 0.002
AZIMUTH_SCALE = 0.01                                        # deg per LSB
SEQ_PERIOD_US = 55.296
CHANNEL_PERIOD_US = 2.304
FACTORY_RETURN_STRONGEST = 0x37
FACTORY_PRODUCT_VLP16 = 0x22
DATA_PORT = 2368

# Firing order within a sequence == ring id: lasers interleave low/high
# elevations (VLP-16 manual table 9-1; same table as the synthetic model).
VLP16_ELEVATIONS_DEG = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    dtype=np.float64)


@dataclasses.dataclass
class FiringSequences:
    """Decoded firing sequences, flattened over packets.

    azimuth_deg: (S,) azimuth of each 16-laser firing sequence (deg,
      second-in-block firings interpolated).
    dist_m: (S, 16) range per laser, 0 = no return.
    intensity: (S, 16) reflectivity 0-255.
    time_s: (S,) absolute device time of the sequence (from the packet
      timestamp plus the in-packet firing offset).
    """

    azimuth_deg: np.ndarray
    dist_m: np.ndarray
    intensity: np.ndarray
    time_s: np.ndarray


def parse_packet_batch(data: np.ndarray) -> FiringSequences:
    """Decode (P, 1206) uint8 packets -> FiringSequences (vectorized).

    Raises ValueError on a wrong packet size or a corrupt block flag (the
    loud-failure analog of the reference driver's bailouts,
    lms_mini_lib.cpp:78-82).
    """
    data = np.asarray(data, np.uint8)
    if data.ndim == 1:
        data = data[None]
    P = data.shape[0]
    if data.shape[1] != PACKET_SIZE:
        raise ValueError(f"packet size {data.shape[1]} != {PACKET_SIZE}")

    blocks = data[:, : BLOCKS_PER_PACKET * 100].reshape(
        P, BLOCKS_PER_PACKET, 100)
    flag_ok = (blocks[:, :, 0] == BLOCK_FLAG[0]) & (
        blocks[:, :, 1] == BLOCK_FLAG[1])
    if not flag_ok.all():
        bad = int(np.argmin(flag_ok.reshape(-1)))
        raise ValueError(
            f"corrupt block flag in packet {bad // BLOCKS_PER_PACKET} "
            f"block {bad % BLOCKS_PER_PACKET}")

    az_block = (blocks[:, :, 2].astype(np.uint32)
                | (blocks[:, :, 3].astype(np.uint32) << 8)
                ).astype(np.float64) * AZIMUTH_SCALE       # (P, 12) deg

    ch = blocks[:, :, 4:].reshape(P, BLOCKS_PER_PACKET, 32, 3)
    dist = (ch[..., 0].astype(np.uint32)
            | (ch[..., 1].astype(np.uint32) << 8)).astype(np.float64)
    dist = dist * DIST_RESOLUTION_M                         # (P, 12, 32)
    inten = ch[..., 2].astype(np.float32)

    # azimuth of the second firing in each block: midpoint to the next
    # block's azimuth (wrap-aware); the last block reuses the previous gap
    flat_az = az_block.reshape(-1)                          # (P*12,)
    gap = np.diff(flat_az)
    gap = np.mod(gap, 360.0)
    gap = np.append(gap, gap[-1] if gap.size else 0.0)
    az2 = np.mod(flat_az + 0.5 * gap, 360.0)
    az_seq = np.stack([flat_az, az2], axis=1).reshape(-1)   # (P*24,)

    dist_seq = dist.reshape(P, BLOCKS_PER_PACKET, 2, LASERS).reshape(
        -1, LASERS)
    inten_seq = inten.reshape(P, BLOCKS_PER_PACKET, 2, LASERS).reshape(
        -1, LASERS)

    stamp_us = np.frombuffer(
        data[:, 1200:1204].copy().tobytes(), dtype="<u4").astype(np.float64)
    seq_off = np.arange(SEQS_PER_PACKET, dtype=np.float64) * SEQ_PERIOD_US
    time_s = ((stamp_us[:, None] + seq_off[None, :]) * 1e-6).reshape(-1)

    return FiringSequences(azimuth_deg=az_seq, dist_m=dist_seq,
                           intensity=inten_seq, time_s=time_s)


def sequences_to_points(seqs: FiringSequences, min_range: float = 0.4,
                        max_range: float = 130.0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Polar -> cartesian in the sensor frame, range-gated.

    Gate defaults match universal_velodyne.launch:47-48 (min_range 0.4,
    max_range 130). Returns (points (N, 3) f32, intensity (N,) f32,
    ring (N,) i32, azimuth_rad (N,) f32, time_s (N,) f64) for the valid
    returns, azimuth-major then ring order.

    Frame convention matches the synthetic VLP-16 model
    (synthetic.vlp16_directions): x = cos(el) cos(az), y = cos(el) sin(az),
    z = sin(el).
    """
    el = np.radians(VLP16_ELEVATIONS_DEG)                   # (16,)
    az = np.radians(seqs.azimuth_deg)[:, None]              # (S, 1)
    r = seqs.dist_m                                         # (S, 16)
    valid = (r >= min_range) & (r <= max_range)

    ce, se = np.cos(el)[None, :], np.sin(el)[None, :]
    x = r * ce * np.cos(az)
    y = r * ce * np.sin(az)
    z = r * se
    ch_off = np.arange(LASERS, dtype=np.float64) * CHANNEL_PERIOD_US * 1e-6
    t = seqs.time_s[:, None] + ch_off[None, :]

    pts = np.stack([x[valid], y[valid], z[valid]], axis=1).astype(np.float32)
    ring = np.broadcast_to(np.arange(LASERS, dtype=np.int32), r.shape)[valid]
    azf = np.broadcast_to(az, r.shape)[valid].astype(np.float32)
    return (pts, seqs.intensity[valid].astype(np.float32), ring.copy(),
            azf.copy(), t[valid])


def encode_packets(azimuth_deg: np.ndarray, dist_m: np.ndarray,
                   intensity: Optional[np.ndarray] = None,
                   start_time_s: float = 0.0) -> np.ndarray:
    """Inverse of parse_packet_batch: firing sequences -> raw packets.

    azimuth_deg: (S,) azimuth per firing sequence. Only even-index (block
      base) azimuths are stored on the wire; odd ones are reconstructed by
      the parser's interpolation, so for a uniform azimuth grid the
      round-trip is exact.
    dist_m: (S, 16); intensity: (S, 16) 0-255 (default 100).
    Returns (ceil(S/24), 1206) uint8; the tail packet repeats the last
    sequence's azimuth with zero ranges (no returns), which decoders skip.
    """
    S = azimuth_deg.shape[0]
    if dist_m.shape != (S, LASERS):
        raise ValueError(f"dist shape {dist_m.shape} != ({S}, {LASERS})")
    if intensity is None:
        intensity = np.full((S, LASERS), 100.0)
    n_pkt = -(-S // SEQS_PER_PACKET)
    Sp = n_pkt * SEQS_PER_PACKET
    az = np.concatenate([azimuth_deg,
                         np.repeat(azimuth_deg[-1:], Sp - S)])
    d = np.concatenate([dist_m, np.zeros((Sp - S, LASERS))])
    it = np.concatenate([intensity, np.zeros((Sp - S, LASERS))])

    pkts = np.zeros((n_pkt, PACKET_SIZE), np.uint8)
    blocks = pkts[:, : BLOCKS_PER_PACKET * 100].reshape(
        n_pkt, BLOCKS_PER_PACKET, 100)
    blocks[:, :, 0] = BLOCK_FLAG[0]
    blocks[:, :, 1] = BLOCK_FLAG[1]
    az_block = az.reshape(-1, SEQS_PER_BLOCK)[:, 0]         # first firing
    az_i = np.round(az_block / AZIMUTH_SCALE).astype(np.uint32) % 36000
    blocks[:, :, 2] = (az_i & 0xFF).reshape(n_pkt, BLOCKS_PER_PACKET)
    blocks[:, :, 3] = (az_i >> 8).reshape(n_pkt, BLOCKS_PER_PACKET)

    d_i = np.clip(np.round(d / DIST_RESOLUTION_M), 0, 0xFFFF).astype(
        np.uint32).reshape(n_pkt, BLOCKS_PER_PACKET, 32)
    i_i = np.clip(np.round(it), 0, 255).astype(np.uint8).reshape(
        n_pkt, BLOCKS_PER_PACKET, 32)
    ch = blocks[:, :, 4:].reshape(n_pkt, BLOCKS_PER_PACKET, 32, 3)
    ch[..., 0] = d_i & 0xFF
    ch[..., 1] = d_i >> 8
    ch[..., 2] = i_i

    t_us = (start_time_s * 1e6
            + np.arange(n_pkt, dtype=np.float64)
            * SEQS_PER_PACKET * SEQ_PERIOD_US)
    pkts[:, 1200:1204] = np.frombuffer(
        np.round(t_us).astype("<u4").tobytes(), np.uint8).reshape(n_pkt, 4)
    pkts[:, 1204] = FACTORY_RETURN_STRONGEST
    pkts[:, 1205] = FACTORY_PRODUCT_VLP16
    return pkts


# ---------------------------------------------------------------------------
# Revolution assembly (velodyne_pointcloud nodelet semantics, cut at 0 deg)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Revolution:
    """One assembled 360-degree cloud in the sensor frame."""

    points: np.ndarray      # (N, 3) float32
    intensity: np.ndarray   # (N,) float32
    ring: np.ndarray        # (N,) int32
    time_s: np.ndarray      # (N,) float64 absolute device time per point
    stamp: float            # device time of the first firing


class VelodyneStream:
    """Feed raw packets; pop full revolutions.

    A revolution is cut when the azimuth wraps (decreases), matching the
    nodelet's default cut-at-0 behavior for a continuously spinning
    sensor.
    """

    def __init__(self, min_range: float = 0.4, max_range: float = 130.0):
        self.min_range = min_range
        self.max_range = max_range
        self._pend: List[FiringSequences] = []
        self._last_az = None
        self._done: List[Revolution] = []

    def push(self, packets: np.ndarray) -> None:
        seqs = parse_packet_batch(packets)
        az = seqs.azimuth_deg
        prev = np.concatenate(
            [[az[0] if self._last_az is None else self._last_az], az[:-1]])
        cuts = np.nonzero(az < prev - 1e-9)[0]
        start = 0
        for c in cuts:
            self._pend.append(self._slice(seqs, start, int(c)))
            self._emit()
            start = int(c)
        self._pend.append(self._slice(seqs, start, len(az)))
        self._last_az = float(az[-1]) if az.size else self._last_az

    @staticmethod
    def _slice(s: FiringSequences, a: int, b: int) -> FiringSequences:
        return FiringSequences(azimuth_deg=s.azimuth_deg[a:b],
                               dist_m=s.dist_m[a:b],
                               intensity=s.intensity[a:b],
                               time_s=s.time_s[a:b])

    def _emit(self) -> None:
        segs = [s for s in self._pend if s.azimuth_deg.size]
        self._pend = []
        if not segs:
            return
        merged = FiringSequences(
            azimuth_deg=np.concatenate([s.azimuth_deg for s in segs]),
            dist_m=np.concatenate([s.dist_m for s in segs]),
            intensity=np.concatenate([s.intensity for s in segs]),
            time_s=np.concatenate([s.time_s for s in segs]))
        pts, inten, ring, _, t = sequences_to_points(
            merged, self.min_range, self.max_range)
        self._done.append(Revolution(points=pts, intensity=inten, ring=ring,
                                     time_s=t,
                                     stamp=float(merged.time_s[0])))

    def pop(self) -> Optional[Revolution]:
        return self._done.pop(0) if self._done else None

    def flush(self) -> Optional[Revolution]:
        """Emit whatever partial revolution is pending (end of stream)."""
        self._emit()
        return self.pop()


# ---------------------------------------------------------------------------
# pcap file IO (libpcap classic format, Ethernet II + IPv4 + UDP)
# ---------------------------------------------------------------------------

_PCAP_MAGIC_US_LE = 0xA1B2C3D4
_PCAP_MAGIC_NS_LE = 0xA1B23C4D
_LINKTYPE_ETHERNET = 1


def read_pcap(path: str, port: int = DATA_PORT
              ) -> Iterator[Tuple[float, bytes]]:
    """Yield (timestamp_s, udp_payload) for UDP packets to ``port``.

    Handles both byte orders and both us/ns pcap flavors; skips non-IPv4 /
    non-UDP / other-port records (exactly what the velodyne driver's pcap
    replay does with a mixed capture).
    """
    with open(path, "rb") as f:
        hdr = f.read(24)
        if len(hdr) < 24:
            raise ValueError("not a pcap file (short global header)")
        magic = struct.unpack("<I", hdr[:4])[0]
        if magic == _PCAP_MAGIC_US_LE:
            bo, ts_div = "<", 1e6
        elif magic == _PCAP_MAGIC_NS_LE:
            bo, ts_div = "<", 1e9
        elif struct.unpack(">I", hdr[:4])[0] == _PCAP_MAGIC_US_LE:
            bo, ts_div = ">", 1e6
        elif struct.unpack(">I", hdr[:4])[0] == _PCAP_MAGIC_NS_LE:
            bo, ts_div = ">", 1e9
        else:
            raise ValueError(f"not a pcap file (magic {hdr[:4]!r})")
        linktype = struct.unpack(bo + "I", hdr[20:24])[0]
        if linktype != _LINKTYPE_ETHERNET:
            raise ValueError(f"unsupported pcap linktype {linktype}")

        while True:
            rec = f.read(16)
            if len(rec) < 16:
                return
            ts_s, ts_frac, incl, _orig = struct.unpack(bo + "IIII", rec)
            frame = f.read(incl)
            if len(frame) < incl:
                return
            payload = _udp_payload(frame, port)
            if payload is not None:
                yield ts_s + ts_frac / ts_div, payload


def _udp_payload(frame: bytes, port: int) -> Optional[bytes]:
    if len(frame) < 14 + 20 + 8:
        return None
    ethertype = struct.unpack(">H", frame[12:14])[0]
    if ethertype != 0x0800:                                 # IPv4 only
        return None
    ihl = (frame[14] & 0x0F) * 4
    if frame[14] >> 4 != 4 or frame[14 + 9] != 17:          # v4 + UDP
        return None
    udp = 14 + ihl
    dport = struct.unpack(">H", frame[udp + 2: udp + 4])[0]
    if dport != port:
        return None
    ulen = struct.unpack(">H", frame[udp + 4: udp + 6])[0]
    return frame[udp + 8: udp + ulen]


def write_pcap(path: str, packets: np.ndarray,
               timestamps_s: Optional[np.ndarray] = None,
               port: int = DATA_PORT) -> str:
    """Write data packets as a classic us-resolution pcap (Ethernet/IPv4).

    The synthetic-capture twin of a real VLP-16 recording: byte-for-byte
    replayable through read_pcap -> VelodyneStream.
    """
    packets = np.asarray(packets, np.uint8)
    if packets.ndim == 1:
        packets = packets[None]
    n = packets.shape[0]
    if timestamps_s is None:
        timestamps_s = (np.arange(n, dtype=np.float64)
                        * SEQS_PER_PACKET * SEQ_PERIOD_US * 1e-6)
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", _PCAP_MAGIC_US_LE, 2, 4, 0, 0,
                            65535, _LINKTYPE_ETHERNET))
        eth = (b"\xff\xff\xff\xff\xff\xff" + b"\x60\x76\x88\x00\x00\x00"
               + b"\x08\x00")
        for i in range(n):
            payload = packets[i].tobytes()
            ulen = 8 + len(payload)
            ip_len = 20 + ulen
            ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, ip_len, i & 0xFFFF,
                             0x4000, 255, 17, 0,
                             bytes([192, 168, 1, 201]),
                             bytes([255, 255, 255, 255]))
            udp = struct.pack(">HHHH", port, port, ulen, 0)
            frame = eth + ip + udp + payload
            ts = float(timestamps_s[i])
            f.write(struct.pack("<IIII", int(ts), int(round((ts % 1) * 1e6)),
                                len(frame), len(frame)))
            f.write(frame)
    return path
