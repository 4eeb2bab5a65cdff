"""rosbag 1.x (V2.0) reader/writer — the ROS-bag offline replay path.

Copy of ``tpu_slam.ingest.rosbag`` (numpy only, the same code) so that
the port imports nothing of ``tpu_slam``; its tests hold what it
writes and decodes byte for byte against the original's.

The reference replays recorded sequences as ROS bags through the node graph
(`m3d/m3dunit_base/launch/universal_velodyne.launch:49,64`
pcap/bag replay args; SURVEY.md §2.2 "Offline data path"). This module reads
the self-contained rosbag V2.0 container directly — no ROS installation —
and decodes the three message types the m3d pipeline exchanges:

  * ``sensor_msgs/PointCloud2``  — aggregated 3D scans / Velodyne clouds
    (the `cloud` topic of m3d_aggregator.cpp:188-223)
  * ``sensor_msgs/LaserScan``    — raw 2D lines (lms_poller.cpp:65-121)
  * ``tf2_msgs/TFMessage``       — the TF chain (transformBroadcaster.py)

``bag_to_dataset`` converts any such bag into the npz dataset format of
`ingest.dataset`, so `cli/run_odometry --dataset` drives straight off a
public m3d/VLP-16 recording. A minimal writer exists so tests can round-trip
synthetic captures through the real byte format.

Format notes (rosbag V2.0, all integers little-endian):
  file      = "#ROSBAG V2.0\\n" record*
  record    = u32 header_len, header, u32 data_len, data
  header    = ( u32 field_len, name '=' value )*
  op codes  = 0x03 bag header, 0x05 chunk, 0x07 connection,
              0x02 message data, 0x04 index, 0x06 chunk info
Chunks ('none' or 'bz2' compression; 'lz4' needs a codec this image lacks)
contain nested connection/message records.
"""

from __future__ import annotations

import bz2
import dataclasses
import io
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07


# ---------------------------------------------------------------------------
# Record-level container parsing
# ---------------------------------------------------------------------------

def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated bag record")
    return b


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        field = name + b"=" + value
        out += struct.pack("<I", len(field)) + field
    return out


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    lenb = f.read(4)
    if len(lenb) < 4:
        return None
    (hlen,) = struct.unpack("<I", lenb)
    header = _parse_header(_read_exact(f, hlen))
    (dlen,) = struct.unpack("<I", _read_exact(f, 4))
    data = _read_exact(f, dlen)
    return header, data


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str = ""


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float            # record receive time, seconds
    raw: bytes              # serialized message body


class BagReader:
    """Sequential rosbag V2.0 reader (index records are skipped).

    Iterating yields BagMessage for every message in file order. Chunked
    ('none'/'bz2') and unchunked layouts are both handled.
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path}: not a rosbag V2.0 file (magic {magic!r})")
        self.connections: Dict[int, Connection] = {}

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- iteration ----------------------------------------------------------

    def __iter__(self) -> Iterator[BagMessage]:
        self._f.seek(len(_MAGIC))
        while True:
            rec = _read_record(self._f)
            if rec is None:
                return
            header, data = rec
            yield from self._dispatch(header, data)

    def _dispatch(self, header, data) -> Iterator[BagMessage]:
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CONN:
            self._add_connection(header, data)
        elif op == OP_CHUNK:
            comp = header.get(b"compression", b"none").decode()
            if comp == "bz2":
                data = bz2.decompress(data)
            elif comp == "lz4":
                try:
                    import lz4.frame  # noqa: F401  (not in this image)
                    data = lz4.frame.decompress(data)
                except ImportError as e:
                    raise NotImplementedError(
                        "bag uses lz4 chunks and no lz4 codec is "
                        "available; re-record with --bz2 or none") from e
            elif comp != "none":
                raise NotImplementedError(f"chunk compression {comp!r}")
            sub = io.BytesIO(data)
            while True:
                rec = _read_record(sub)
                if rec is None:
                    return
                yield from self._dispatch(*rec)
        elif op == OP_MSG:
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            sec, nsec = struct.unpack("<II", header[b"time"])
            conn = self.connections.get(conn_id)
            if conn is None:
                return
            yield BagMessage(topic=conn.topic, msg_type=conn.msg_type,
                             stamp=sec + nsec * 1e-9, raw=data)
        # OP_BAGHDR / OP_INDEX / OP_CHUNKINFO: metadata, skipped

    def _add_connection(self, header, data):
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        sub = _parse_header(data)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=sub.get(b"topic", topic.encode()).decode() or topic,
            msg_type=sub.get(b"type", b"").decode(),
            md5sum=sub.get(b"md5sum", b"").decode())

    def topics(self) -> Dict[str, str]:
        """{topic: msg_type} discovered so far (full after one iteration)."""
        return {c.topic: c.msg_type for c in self.connections.values()}


# ---------------------------------------------------------------------------
# ROS1 message deserialization (little-endian wire format)
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f32(self):
        (v,) = struct.unpack_from("<f", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def time(self):
        sec, nsec = struct.unpack_from("<II", self.buf, self.off)
        self.off += 8
        return sec + nsec * 1e-9

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n].decode(errors="replace")
        self.off += n
        return s

    def bytes_(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def f32_array(self):
        n = self.u32()
        a = np.frombuffer(self.buf, "<f4", count=n, offset=self.off).copy()
        self.off += 4 * n
        return a


def _read_std_header(c: _Cursor) -> Tuple[float, str]:
    c.u32()                  # seq
    stamp = c.time()
    frame_id = c.string()
    return stamp, frame_id


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


_PF_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
              7: "f4", 8: "f8"}


@dataclasses.dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: List[PointField]
    point_step: int
    data: bytes

    def field_array(self, name: str) -> Optional[np.ndarray]:
        for f in self.fields:
            if f.name == name:
                dt = np.dtype("<" + _PF_DTYPES[f.datatype])
                n = self.height * self.width
                raw = np.frombuffer(self.data, np.uint8)
                raw = raw.reshape(n, self.point_step)
                sub = raw[:, f.offset:f.offset + dt.itemsize]
                return np.ascontiguousarray(sub).view(dt).reshape(n)
        return None

    def xyz(self) -> Tuple[np.ndarray, np.ndarray]:
        """((N, 3) float32, valid (N,) bool) — NaN/inf points masked out."""
        cols = [self.field_array(k) for k in ("x", "y", "z")]
        if any(c is None for c in cols):
            raise ValueError("PointCloud2 lacks x/y/z fields")
        pts = np.stack([c.astype(np.float32) for c in cols], axis=1)
        valid = np.isfinite(pts).all(axis=1)
        return np.where(valid[:, None], pts, 0.0).astype(np.float32), valid


def parse_pointcloud2(raw: bytes) -> PointCloud2:
    c = _Cursor(raw)
    stamp, frame_id = _read_std_header(c)
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        fields.append(PointField(name=name, offset=c.u32(),
                                 datatype=c.u8(), count=c.u32()))
    c.u8()                   # is_bigendian
    point_step = c.u32()
    c.u32()                  # row_step
    dlen = c.u32()
    data = c.bytes_(dlen)
    return PointCloud2(stamp=stamp, frame_id=frame_id, height=height,
                       width=width, fields=fields, point_step=point_step,
                       data=data)


@dataclasses.dataclass
class LaserScan:
    stamp: float
    frame_id: str
    angle_min: float
    angle_increment: float
    range_min: float
    range_max: float
    ranges: np.ndarray
    intensities: np.ndarray

    def xy(self) -> Tuple[np.ndarray, np.ndarray]:
        """((N, 3) float32 sensor-frame points, valid) — the polar->cartesian
        expansion of m3d_aggregator.cpp:269-286."""
        ang = self.angle_min + np.arange(len(self.ranges)) \
            * self.angle_increment
        r = self.ranges
        valid = np.isfinite(r) & (r >= self.range_min) & (r <= self.range_max)
        r = np.where(valid, r, 0.0)
        return (np.stack([r * np.cos(ang), r * np.sin(ang),
                          np.zeros_like(r)], axis=1).astype(np.float32),
                valid)


def parse_laserscan(raw: bytes) -> LaserScan:
    c = _Cursor(raw)
    stamp, frame_id = _read_std_header(c)
    angle_min = c.f32()
    c.f32()                  # angle_max (derivable)
    angle_increment = c.f32()
    c.f32()                  # time_increment
    c.f32()                  # scan_time
    range_min, range_max = c.f32(), c.f32()
    ranges = c.f32_array()
    intensities = c.f32_array()
    return LaserScan(stamp=stamp, frame_id=frame_id, angle_min=angle_min,
                     angle_increment=angle_increment, range_min=range_min,
                     range_max=range_max, ranges=ranges,
                     intensities=intensities)


@dataclasses.dataclass
class TransformStamped:
    stamp: float
    frame_id: str
    child_frame_id: str
    translation: np.ndarray   # (3,)
    rotation: np.ndarray      # (4,) xyzw

    def matrix(self) -> np.ndarray:
        x, y, z, w = self.rotation
        t = np.eye(4)
        t[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        t[:3, 3] = self.translation
        return t


def parse_tf_message(raw: bytes) -> List[TransformStamped]:
    c = _Cursor(raw)
    n = c.u32()
    out = []
    for _ in range(n):
        stamp, frame_id = _read_std_header(c)
        child = c.string()
        trans = np.array([c.f64(), c.f64(), c.f64()])
        rot = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
        out.append(TransformStamped(stamp=stamp, frame_id=frame_id,
                                    child_frame_id=child,
                                    translation=trans, rotation=rot))
    return out


# ---------------------------------------------------------------------------
# Bag -> dataset conversion
# ---------------------------------------------------------------------------

def bag_to_dataset(bag_path: str, out_root: str,
                   cloud_topic: Optional[str] = None,
                   gt_frame: Optional[str] = None) -> str:
    """Convert every PointCloud2 on ``cloud_topic`` into an npz dataset.

    ``cloud_topic`` defaults to the first PointCloud2 topic found. When
    ``gt_frame`` is given, /tf transforms whose child matches the cloud's
    frame (or ``gt_frame`` itself as child) are attached as per-scan
    ground-truth poses (nearest earlier stamp) for ATE evaluation.
    """
    from tpu_slam_torch.ingest.dataset import DatasetWriter, ScanRecord

    tf_track: List[TransformStamped] = []
    writer = DatasetWriter(out_root, meta={"source_bag":
                                           os.path.basename(bag_path)})
    with BagReader(bag_path) as bag:
        for msg in bag:
            if msg.msg_type == "tf2_msgs/TFMessage":
                tf_track.extend(parse_tf_message(msg.raw))
                continue
            if msg.msg_type != "sensor_msgs/PointCloud2":
                continue
            if cloud_topic is None:
                cloud_topic = msg.topic
            if msg.topic != cloud_topic:
                continue
            pc = parse_pointcloud2(msg.raw)
            pts, valid = pc.xyz()
            inten = pc.field_array("intensity")
            gt = None
            if gt_frame is not None:
                gt = _nearest_tf(tf_track, gt_frame, pc.frame_id, pc.stamp)
            writer.append(ScanRecord(
                points=pts, mask=valid,
                intensity=None if inten is None
                else inten.astype(np.float32),
                stamp=pc.stamp, frame_id=pc.frame_id, gt_pose=gt))
    writer.flush()
    return out_root


def _nearest_tf(track: List[TransformStamped], parent: str, child: str,
                stamp: float) -> Optional[np.ndarray]:
    best = None
    for tf in track:
        if tf.frame_id.lstrip("/") != parent.lstrip("/"):
            continue
        if tf.child_frame_id.lstrip("/") != child.lstrip("/"):
            continue
        if tf.stamp <= stamp and (best is None or tf.stamp > best.stamp):
            best = tf
    return best.matrix() if best is not None else None


# ---------------------------------------------------------------------------
# Minimal writer (tests / synthetic captures through the real byte format)
# ---------------------------------------------------------------------------

def _time_bytes(stamp: float) -> bytes:
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    return struct.pack("<II", sec, nsec)


def serialize_pointcloud2(points: np.ndarray, stamp: float,
                          frame_id: str = "velodyne",
                          intensity: Optional[np.ndarray] = None) -> bytes:
    """(N, 3) float32 -> serialized sensor_msgs/PointCloud2 body."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    fields = [("x", 0), ("y", 4), ("z", 8)]
    step = 12
    if intensity is not None:
        fields.append(("intensity", 12))
        step = 16
    body = io.BytesIO()
    body.write(struct.pack("<I", 0))                     # seq
    body.write(_time_bytes(stamp))
    fid = frame_id.encode()
    body.write(struct.pack("<I", len(fid)) + fid)
    body.write(struct.pack("<II", 1, n))                 # height, width
    body.write(struct.pack("<I", len(fields)))
    for name, off in fields:
        nb = name.encode()
        body.write(struct.pack("<I", len(nb)) + nb)
        body.write(struct.pack("<IBI", off, 7, 1))       # offset, f32, count
    body.write(struct.pack("<B", 0))                     # is_bigendian
    body.write(struct.pack("<II", step, step * n))       # point/row step
    rec = np.zeros((n, step // 4), np.float32)
    rec[:, :3] = points
    if intensity is not None:
        rec[:, 3] = np.asarray(intensity, np.float32)
    raw = rec.tobytes()
    body.write(struct.pack("<I", len(raw)) + raw)
    body.write(struct.pack("<B", 1))                     # is_dense
    return body.getvalue()


def serialize_tf_message(transforms: List[TransformStamped]) -> bytes:
    body = io.BytesIO()
    body.write(struct.pack("<I", len(transforms)))
    for tf in transforms:
        body.write(struct.pack("<I", 0))
        body.write(_time_bytes(tf.stamp))
        fid = tf.frame_id.encode()
        body.write(struct.pack("<I", len(fid)) + fid)
        cid = tf.child_frame_id.encode()
        body.write(struct.pack("<I", len(cid)) + cid)
        body.write(struct.pack("<3d", *tf.translation))
        body.write(struct.pack("<4d", *tf.rotation))
    return body.getvalue()


class BagWriter:
    """Write a chunked, uncompressed rosbag V2.0 file."""

    _TYPES = {
        "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
        "sensor_msgs/LaserScan": "90c7ef2dc6895d81024acba2ac42f369",
        "tf2_msgs/TFMessage": "94810edda583a504dfda3829e70d7eec",
    }

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        # bag header record, padded to 4096 per the spec convention
        hdr = _encode_header({b"op": bytes([OP_BAGHDR]),
                              b"index_pos": struct.pack("<Q", 0),
                              b"conn_count": struct.pack("<I", 0),
                              b"chunk_count": struct.pack("<I", 0)})
        pad = 4096 - len(hdr) - 8
        self._f.write(struct.pack("<I", len(hdr)) + hdr)
        self._f.write(struct.pack("<I", pad) + b" " * pad)
        self._conns: Dict[str, int] = {}
        self._chunk = io.BytesIO()

    def _conn_id(self, topic: str, msg_type: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        hdr = _encode_header({b"op": bytes([OP_CONN]),
                              b"conn": struct.pack("<I", cid),
                              b"topic": topic.encode()})
        sub = _encode_header({b"topic": topic.encode(),
                              b"type": msg_type.encode(),
                              b"md5sum":
                              self._TYPES.get(msg_type, "*").encode(),
                              b"message_definition": b""})
        self._chunk.write(struct.pack("<I", len(hdr)) + hdr)
        self._chunk.write(struct.pack("<I", len(sub)) + sub)
        return cid

    def write(self, topic: str, msg_type: str, raw: bytes, stamp: float):
        cid = self._conn_id(topic, msg_type)
        hdr = _encode_header({b"op": bytes([OP_MSG]),
                              b"conn": struct.pack("<I", cid),
                              b"time": _time_bytes(stamp)})
        self._chunk.write(struct.pack("<I", len(hdr)) + hdr)
        self._chunk.write(struct.pack("<I", len(raw)) + raw)

    def close(self):
        data = self._chunk.getvalue()
        hdr = _encode_header({b"op": bytes([OP_CHUNK]),
                              b"compression": b"none",
                              b"size": struct.pack("<I", len(data))})
        self._f.write(struct.pack("<I", len(hdr)) + hdr)
        self._f.write(struct.pack("<I", len(data)) + data)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
