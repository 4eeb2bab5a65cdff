"""Frame graph of the rotating 3D scanner — the TF chain as functions.

Port of ``tpu_slam.ingest.frames``. One kinematic model stands in for the
reference's two TF publishers:

  * encoder node (m3d/m3dunit_base/src/encoder_node_li.cpp:87-109): the
    dynamic ``m3d_link -> m3d_rot_laser_link`` transform — fixed lever arm
    (-0.0835, 0, 0.1835) and rotation RPY(0, -pi/2, angle);
  * transformBroadcaster.py:126-141: the static sensor-model offset and
    the persisted calibration link.

The full chain maps laser-frame points into the unit base frame:

    T_base_laser(angle) = T_rot(angle) @ T_calib @ T_sensor

Encoder semantics (driverLib.cpp:202-241): angle = -2*pi*(ticks mod
enc_res)/enc_res with enc_res = 4 * hardware value; the applied angle
subtracts a homing offset (encoder_node_li.cpp:98, pi by default).

The transforms are float32 torch tensors, computed op for op as the
reference computes them, on the device of the angle given (a batch of
angles gives one (L, 4, 4) tensor).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.consts import const

# Sensor-model mounting offsets (translation xyz, quaternion xyzw), the
# constant tables of transformBroadcaster.py:10-19.
SENSOR_MODELS: Dict[str, Tuple[Tuple[float, float, float],
                               Tuple[float, float, float, float]]] = {
    "TIM500": ((0.0, 0.0035, 0.0), (0.0, 0.0, 0.0, 1.0)),
    "LMS100": ((0.074, 0.0, 0.068), (0.0, 0.0, 0.0, 1.0)),
    "LMS100C": ((0.0, 0.0, 0.068), (0.0, 0.0, 0.0, 1.0)),
    "VLP16": ((0.0, 0.0035, 0.0), (0.0, 0.0, -0.7071068, 0.7071068)),
}

# Rotating-unit lever arm: origin of the rotating laser link in the unit
# base frame (encoder_node_li.cpp:89-90).
ROT_LINK_TRANSLATION = (-0.0835, 0.0, 0.1835)
# Front (static) laser link offset (encoder_node_li.cpp:83-85).
FRONT_LINK_TRANSLATION = (0.0285, 0.0, 0.04)


def _mount(translation, orientation_xyzw, device=None) -> torch.Tensor:
    R = se3.quat_to_matrix(torch.tensor(orientation_xyzw,
                                        dtype=torch.float32, device=device))
    return se3.from_rt(R, torch.tensor(translation, dtype=torch.float32,
                                       device=device))


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Static mounting description of a supported laser."""

    name: str
    translation: Tuple[float, float, float]
    orientation_xyzw: Tuple[float, float, float, float]

    @staticmethod
    def by_name(name: str) -> "SensorModel":
        if name not in SENSOR_MODELS:
            raise KeyError(f"unknown sensor model {name!r}; "
                           f"known: {sorted(SENSOR_MODELS)}")
        t, q = SENSOR_MODELS[name]
        return SensorModel(name=name, translation=t, orientation_xyzw=q)

    def transform(self, device=None) -> torch.Tensor:
        return _mount(self.translation, self.orientation_xyzw, device)


@dataclasses.dataclass
class Calibration:
    """The persisted 6-DoF laser calibration offset.

    JSON on disk is ``[[tx,ty,tz],[qx,qy,qz,qw]]``, the reference's
    m3d_calibration.yaml (transformBroadcaster.py:25-60): a file written by
    either package, or by the reference stack, loads in the others.
    """

    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation_xyzw: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)

    @staticmethod
    def default_path() -> str:
        home = os.environ.get("ROS_HOME") or os.path.join(
            os.environ.get("HOME", "."), ".ros")
        return os.path.join(home, "m3d_calibration.yaml")

    @staticmethod
    def load(path: Optional[str] = None) -> "Calibration":
        """Load, creating an identity file if absent (reference behaviour)."""
        path = path or Calibration.default_path()
        try:
            with open(path) as f:
                matrix = json.load(f)
        except (OSError, json.JSONDecodeError):
            matrix = [[0, 0, 0], [0, 0, 0, 1]]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(matrix, f)
        return Calibration(translation=tuple(matrix[0]),
                           orientation_xyzw=tuple(matrix[1]))

    def save(self, path: Optional[str] = None) -> str:
        path = path or Calibration.default_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump([list(self.translation), list(self.orientation_xyzw)], f)
        return path

    def transform(self, device=None) -> torch.Tensor:
        return _mount(self.translation, self.orientation_xyzw, device)


def encoder_ticks_to_angle(ticks: torch.Tensor, enc_res: int) -> torch.Tensor:
    """Raw encoder counts -> rotation angle in radians (float32):
    -2*pi*(ticks mod enc_res)/enc_res (driverLib.cpp:202-217, :230-241)."""
    value = torch.remainder(torch.as_tensor(ticks), enc_res)
    return -2.0 * math.pi * value.to(torch.float32) / enc_res


def rotation_link_transform(angle: torch.Tensor) -> torch.Tensor:
    """Unit-base -> rotating-laser-link transform at encoder ``angle``
    (float32, any batch shape -> (..., 4, 4)): RPY(0, -pi/2, angle) about
    the lever arm (encoder_node_li.cpp:89-104)."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    q = se3.quat_from_euler(torch.zeros_like(angle),
                            torch.full_like(angle, -0.5 * math.pi), angle)
    R = se3.quat_to_matrix(q)
    # a device constant: a captured line computes this transform
    t = const(ROT_LINK_TRANSLATION, R.dtype, R.device)
    return se3.from_rt(R, t.expand(R.shape[:-2] + (3,)))


def front_laser_transform(sensor: Optional[SensorModel] = None,
                          device=None) -> torch.Tensor:
    """Static unit-base -> front-laser transform: the fixed front-link
    lever arm (encoder_node_li.cpp:83-85) composed with the sensor-model
    mounting offset, as the rotating laser's static tail is."""
    t = torch.tensor(FRONT_LINK_TRANSLATION, dtype=torch.float32,
                     device=device)
    T = se3.from_rt(torch.eye(3, dtype=torch.float32, device=device), t)
    if sensor is not None:
        T = se3.compose(T, sensor.transform(device))
    return T


@dataclasses.dataclass(frozen=True)
class FrameChain:
    """The composed laser-to-base kinematic chain.

    ``T_base_laser(angle) = T_rot(angle) @ T_calib @ T_sensor``, the static
    tail computed once per device. ``encoder_offset`` is the reference's
    homing-offset subtraction (encoder_node_li.cpp:41-43,98; pi by
    default).
    """

    sensor: SensorModel
    calibration: Calibration = dataclasses.field(default_factory=Calibration)
    encoder_offset: float = math.pi
    _tails: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def static_tail(self, device=None) -> torch.Tensor:
        key = str(torch.device(device or "cpu"))
        tail = self._tails.get(key)
        if tail is None:
            tail = se3.compose(self.calibration.transform(device),
                               self.sensor.transform(device))
            self._tails[key] = tail
        return tail

    def base_from_laser(self, angle, device=None) -> torch.Tensor:
        """(…,) encoder angles -> (…, 4, 4) base<-laser transforms.

        ``angle`` is a tensor (the result lands on its device) or a number
        or array (on ``device``, the CPU by default); a Python number is
        filled on the device, so a scalar angle costs no copy.
        """
        if isinstance(angle, torch.Tensor):
            a = angle.to(torch.float32)
        elif isinstance(angle, (int, float)):
            a = torch.full((), angle, dtype=torch.float32, device=device)
        else:
            a = torch.as_tensor(angle, dtype=torch.float32, device=device)
        a = a - self.encoder_offset
        return se3.compose(rotation_link_transform(a),
                           self.static_tail(a.device))


class EncoderHistory:
    """Thread-safe (time, angle) ring with linear interpolation.

    The reference joins the laser and encoder streams by interpolating the
    TF buffer at each scan line's timestamp (m3d_aggregator.cpp:261-262).
    A producer thread pushes samples; ``at(t)`` interpolates between the
    two bracketing samples. Angles are UNWRAPPED on push (each sample is
    brought within pi of the previous one) so interpolation crosses the
    2-pi seam of the encoder model (driverLib.cpp:202-217) correctly.
    """

    def __init__(self, capacity: int = 2048):
        self._t = collections.deque(maxlen=capacity)
        self._a = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, t: float, angle: float) -> None:
        two_pi = 2.0 * math.pi
        with self._lock:
            if self._a:
                last = self._a[-1]
                while angle - last > math.pi:
                    angle -= two_pi
                while angle - last < -math.pi:
                    angle += two_pi
            self._t.append(float(t))
            self._a.append(float(angle))

    def __len__(self) -> int:
        with self._lock:
            return len(self._t)

    def newest_t(self) -> float:
        """Time of the newest sample (-inf when empty): lets a consumer
        wait for a bracketing sample before interpolating."""
        with self._lock:
            return self._t[-1] if self._t else float("-inf")

    def at(self, t: float) -> float:
        """Unwrapped angle at time ``t``.

        Inside the sampled span: linear between the bracketing samples.
        Slightly past the newest sample: extrapolated along the last two
        samples' slope (at most 50 ms ahead), since a consumer asking at
        line-arrival time is usually a fraction of a sampler period ahead
        of the last sample. Before the first sample: clamped to it.
        """
        with self._lock:
            if not self._t:
                raise ValueError("EncoderHistory is empty")
            ts = tuple(self._t)
            an = tuple(self._a)
        i = bisect.bisect_left(ts, t)
        if i <= 0:
            return an[0]
        if i >= len(ts):
            if len(ts) >= 2 and ts[-1] > ts[-2]:
                slope = (an[-1] - an[-2]) / (ts[-1] - ts[-2])
                return an[-1] + slope * min(t - ts[-1], 0.05)
            return an[-1]
        t0, t1 = ts[i - 1], ts[i]
        a0, a1 = an[i - 1], an[i]
        if t1 <= t0:
            return a1
        w = (t - t0) / (t1 - t0)
        return a0 + w * (a1 - a0)
