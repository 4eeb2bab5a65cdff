"""ctypes bindings of the native runtime (``native/src``).

The port's own binding of the repo's C++ device runtime: CoLa-A parsing,
the SICK TCP client, the rotating unit's motor-controller protocol, the
scan-line feeder ring between the poller thread and the consumer, and the
VLP-16 packet decoder (``native/src/tpu_slam_native.h``). Python stays
out of the per-line hot path; these bindings exist for the live pipeline,
the calibration capture and tests.

The library is built from ``native/src/*.cpp`` with
``g++ -std=c++17 -O2 -shared -fPIC -pthread`` at first use, into
``tpu_slam_torch/_build/`` under a name that carries the hash of the
sources, so an edited source is rebuilt and an unchanged one is loaded as
is; nothing is written into ``native/``. There is no fallback: when the
compiler or the sources are missing, or the build or the load fails,
``load`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from tpu_slam_torch.kernels._build import BUILD_DIR

NATIVE_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "src"
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class ScanMeta(ctypes.Structure):
    _fields_ = [
        ("telegram_no", ctypes.c_uint32),
        ("scan_no", ctypes.c_uint32),
        ("time_since_startup_us", ctypes.c_uint32),
        ("time_of_transmission_us", ctypes.c_uint32),
        ("scan_frequency_hz", ctypes.c_float),
        ("scale_factor", ctypes.c_float),
        ("start_angle_deg", ctypes.c_float),
        ("ang_step_deg", ctypes.c_float),
        ("n_dist", ctypes.c_int32),
        ("n_rssi", ctypes.c_int32),
    ]


def _sources():
    srcs = sorted(NATIVE_SRC.glob("*.cpp"))
    if not srcs:
        raise RuntimeError(f"no native sources under {NATIVE_SRC}")
    return srcs


def library_path() -> pathlib.Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in _sources() + sorted(NATIVE_SRC.glob("*.h")):
        h.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"libtpu_slam_native-{h.hexdigest()[:12]}.so"


def build() -> pathlib.Path:
    """Compile ``native/src`` with g++ unless its library exists; returns
    the path. Raises RuntimeError when there is no compiler or it fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime of "
                           "tpu_slam_torch is built from native/src at "
                           "first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, "-I", str(NATIVE_SRC), "-o", tmp,
             *map(str, _sources())], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on native/src:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            _configure(lib)
            _LIB = lib
    return _LIB


def _configure(lib: ctypes.CDLL):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    szp = ctypes.POINTER(ctypes.c_size_t)
    vp, ci = ctypes.c_void_p, ctypes.c_int

    def sig(name, restype, *argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)

    sig("ts_cola_next_frame", ci, u8p, ctypes.c_size_t, szp, szp, szp)
    sig("ts_cola_parse_scan", ci, u8p, ctypes.c_size_t,
        ctypes.POINTER(ScanMeta), f32p, f32p, ctypes.c_int32)
    sig("ts_cola_parse_scan_multi", ci, u8p, ctypes.c_size_t,
        ctypes.POINTER(ScanMeta), f32p, f32p, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p)

    sig("ts_lms_create", vp)
    sig("ts_lms_destroy", None, vp)
    sig("ts_lms_connect", ci, vp, ctypes.c_char_p, ci, ci)
    sig("ts_lms_start_scan", ci, vp)
    sig("ts_lms_poll", ci, vp, ctypes.POINTER(ScanMeta), f32p, f32p,
        ctypes.c_int32, ci)

    sig("ts_m3d_create", vp)
    sig("ts_m3d_destroy", None, vp)
    sig("ts_m3d_connect_tcp", ci, vp, ctypes.c_char_p, ci, ci)
    sig("ts_m3d_connect_serial", ci, vp, ctypes.c_char_p, ci, ci)
    sig("ts_m3d_write_param", ci, vp, ci, ci, ci)
    sig("ts_m3d_get_param", ci, vp, ci, ci, ctypes.POINTER(ctypes.c_int))
    sig("ts_m3d_set_speed", ci, vp, ci)
    sig("ts_m3d_set_position", ci, vp, ctypes.c_double, ci, ci)
    sig("ts_m3d_get_encoder_res", ci, vp, ctypes.POINTER(ctypes.c_int))
    sig("ts_m3d_get_angle", ci, vp, ctypes.POINTER(ctypes.c_double))
    sig("ts_m3d_get_voltage", ci, vp, ctypes.POINTER(ctypes.c_int))
    sig("ts_m3d_set_homing_offset", ci, vp, ci)

    sig("ts_vlp16_decode", ci, u8p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_double, f32p, f32p, i32p, f32p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32)

    sig("ts_feeder_create", vp, ci, ci)
    sig("ts_feeder_destroy", None, vp)
    sig("ts_feeder_push", ci, vp, f32p, f32p, ci, ctypes.c_double,
        ctypes.c_double)
    sig("ts_feeder_pop", ci, vp, f32p, f32p, ci,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ci)
    sig("ts_feeder_dropped", ctypes.c_long, vp)
    sig("ts_feeder_depth", ci, vp)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def parse_telegram_native(payload: bytes, cap: int = 4096
                          ) -> Tuple[ScanMeta, np.ndarray, np.ndarray]:
    """Parse an LMDscandata payload (first echo) through the C++ parser:
    (meta, ranges in m, intensities)."""
    lib = load()
    buf = np.frombuffer(payload, dtype=np.uint8)
    meta = ScanMeta()
    ranges = np.zeros(cap, np.float32)
    intens = np.zeros(cap, np.float32)
    rc = lib.ts_cola_parse_scan(_u8p(buf), len(payload), ctypes.byref(meta),
                                _f32p(ranges), _f32p(intens), cap)
    if rc != 0:
        raise ValueError(f"native parse failed: {rc}")
    return meta, ranges[:meta.n_dist].copy(), intens[:meta.n_rssi].copy()


def parse_telegram_native_multi(payload: bytes, cap: int = 4096,
                                max_echoes: int = 5):
    """Parse an LMDscandata payload with every echo channel (DIST1..5 /
    RSSI1..5) through the C++ parser.

    Returns (meta, dist_echoes, rssi_echoes): lists of per-echo float32
    arrays, one entry per channel present, in echo order.
    """
    lib = load()
    buf = np.frombuffer(payload, dtype=np.uint8)
    meta = ScanMeta()
    ranges = np.zeros((max_echoes, cap), np.float32)
    intens = np.zeros((max_echoes, cap), np.float32)
    n_dist = np.zeros(max_echoes, np.int32)
    n_rssi = np.zeros(max_echoes, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.ts_cola_parse_scan_multi(
        _u8p(buf), len(payload), ctypes.byref(meta), _f32p(ranges),
        _f32p(intens), cap, max_echoes, n_dist.ctypes.data_as(i32p),
        n_rssi.ctypes.data_as(i32p))
    if rc != 0:
        raise ValueError(f"native multi-echo parse failed: {rc}")
    dists = [ranges[e, :n_dist[e]].copy() for e in range(max_echoes)
             if n_dist[e] > 0]
    rssis = [intens[e, :n_rssi[e]].copy() for e in range(max_echoes)
             if n_rssi[e] > 0]
    return meta, dists, rssis


class NativeLms:
    """SICK LMS scanner client (TCP, CoLa-A) of the native runtime."""

    def __init__(self, cap: int = 4096):
        self.lib = load()
        self.h = self.lib.ts_lms_create()
        self.cap = cap

    def connect(self, host: str, port: int = 2111, timeout_ms: int = 2000):
        rc = self.lib.ts_lms_connect(self.h, host.encode(), port, timeout_ms)
        if rc != 0:
            raise ConnectionError(f"lms connect failed: {rc}")

    def start_scan(self):
        rc = self.lib.ts_lms_start_scan(self.h)
        if rc != 0:
            raise ConnectionError(f"start_scan failed: {rc}")

    def poll(self, timeout_ms: int = 1000):
        """(meta, ranges, intensities) of the next telegram; None on a
        timeout; ConnectionError when the stream broke."""
        meta = ScanMeta()
        ranges = np.zeros(self.cap, np.float32)
        intens = np.zeros(self.cap, np.float32)
        rc = self.lib.ts_lms_poll(self.h, ctypes.byref(meta), _f32p(ranges),
                                  _f32p(intens), self.cap, timeout_ms)
        if rc == -4:
            return None
        if rc != 0:
            raise ConnectionError(f"poll failed: {rc}")
        return meta, ranges[:meta.n_dist].copy(), intens[:meta.n_rssi].copy()

    def close(self):
        if self.h:
            self.lib.ts_lms_destroy(self.h)
            self.h = None


class NativeM3d:
    """Rotating-unit motor controller client over the native runtime."""

    def __init__(self):
        self.lib = load()
        self.h = self.lib.ts_m3d_create()

    def _check(self, rc: int, what: str):
        if rc != 0:
            raise ConnectionError(f"{what} failed: {rc}")

    def connect_tcp(self, host: str, port: int = 10001,
                    timeout_ms: int = 2000):
        self._check(self.lib.ts_m3d_connect_tcp(self.h, host.encode(), port,
                                                timeout_ms), "m3d connect")

    def connect_serial(self, device: str, baud: int = 57600,
                       timeout_ms: int = 2000):
        """Serial transport (driverLib.cpp:10-32, default 57600 baud)."""
        self._check(self.lib.ts_m3d_connect_serial(
            self.h, device.encode(), baud, timeout_ms),
            "m3d serial connect")

    def write_param(self, index: int, sub: int, value: int):
        self._check(self.lib.ts_m3d_write_param(self.h, index, sub, value),
                    "write_param")

    def get_param(self, index: int, sub: int) -> int:
        v = ctypes.c_int()
        self._check(self.lib.ts_m3d_get_param(self.h, index, sub,
                                              ctypes.byref(v)), "get_param")
        return v.value

    def set_speed(self, speed: int):
        self._check(self.lib.ts_m3d_set_speed(self.h, speed), "set_speed")

    def set_position(self, pos_rad: float, speed: int, relative: bool):
        self._check(self.lib.ts_m3d_set_position(
            self.h, pos_rad, speed, 1 if relative else 0), "set_position")

    def encoder_res(self) -> int:
        v = ctypes.c_int()
        self._check(self.lib.ts_m3d_get_encoder_res(self.h, ctypes.byref(v)),
                    "get_encoder_res")
        return v.value

    def angle(self) -> float:
        v = ctypes.c_double()
        self._check(self.lib.ts_m3d_get_angle(self.h, ctypes.byref(v)),
                    "get_angle")
        return v.value

    def set_homing_offset(self, offset: int):
        self._check(self.lib.ts_m3d_set_homing_offset(self.h, offset),
                    "set_homing_offset")

    def close(self):
        if self.h:
            self.lib.ts_m3d_destroy(self.h)
            self.h = None


class NativeFeeder:
    """The scan-line ring between the poller thread and the consumer: a
    push into a full ring drops the line and counts it."""

    def __init__(self, n_slots: int, line_cap: int):
        self.lib = load()
        self.h = self.lib.ts_feeder_create(n_slots, line_cap)
        self.cap = line_cap

    def push(self, ranges: np.ndarray, intens: Optional[np.ndarray],
             stamp: float, angle: float) -> bool:
        r = np.ascontiguousarray(ranges, np.float32)
        i = (None if intens is None
             else np.ascontiguousarray(intens, np.float32))
        rc = self.lib.ts_feeder_push(
            self.h, _f32p(r), _f32p(i) if i is not None else None,
            len(r), stamp, angle)
        return rc == 0

    def pop(self, timeout_ms: int = 1000):
        """(ranges, intensities, stamp, angle) of the oldest line; None on
        a timeout."""
        ranges = np.zeros(self.cap, np.float32)
        intens = np.zeros(self.cap, np.float32)
        stamp = ctypes.c_double()
        angle = ctypes.c_double()
        n = self.lib.ts_feeder_pop(self.h, _f32p(ranges), _f32p(intens),
                                   self.cap, ctypes.byref(stamp),
                                   ctypes.byref(angle), timeout_ms)
        if n == -4:
            return None
        if n < 0:
            raise RuntimeError(f"feeder pop failed: {n}")
        return ranges[:n], intens[:n], stamp.value, angle.value

    @property
    def dropped(self) -> int:
        return self.lib.ts_feeder_dropped(self.h)

    @property
    def depth(self) -> int:
        return self.lib.ts_feeder_depth(self.h)

    def close(self):
        if self.h:
            self.lib.ts_feeder_destroy(self.h)
            self.h = None


def vlp16_decode_native(packets: np.ndarray, min_range: float = 0.4,
                        max_range: float = 130.0,
                        cap: Optional[int] = None):
    """Decode VLP-16 packets through the C++ decoder (ts_vlp16_decode).

    The output of ``velodyne.parse_packet_batch`` -> ``sequences_to_points``:
    (points (N, 3) f32, intensity (N,), ring (N,) i32, azimuth_rad (N,)
    f32, time_s (N,) f64).
    """
    lib = load()
    pkts = np.ascontiguousarray(np.atleast_2d(packets), np.uint8)
    n_pkts = pkts.shape[0]
    if cap is None:
        cap = n_pkts * 24 * 16
    xyz = np.zeros((cap, 3), np.float32)
    inten = np.zeros(cap, np.float32)
    ring = np.zeros(cap, np.int32)
    az = np.zeros(cap, np.float32)
    t = np.zeros(cap, np.float64)
    n = lib.ts_vlp16_decode(
        _u8p(pkts), n_pkts, min_range, max_range, _f32p(xyz), _f32p(inten),
        ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _f32p(az),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
    if n < 0:
        raise ValueError(f"native VLP-16 decode failed: {n}")
    return (xyz[:n].copy(), inten[:n].copy(), ring[:n].copy(),
            np.radians(az[:n]).astype(np.float32), t[:n].copy())
