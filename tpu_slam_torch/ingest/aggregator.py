"""Full-rotation scan aggregation: scan lines in, 3D scans out.

Port of ``tpu_slam.ingest.aggregator`` (after the reference aggregator,
m3d/m3d_aggregator/src/m3d_aggregator.cpp). The unit of work is one scan
line (all beams sharing one transform); the state is a set of
fixed-capacity tensors on the device, so a 3D scan is assembled with no
per-point host traffic.

Behaviour of the reference:
  * completeness = the integrated quaternion shortest-path angular
    distance of the line transforms' rotations exceeding a threshold
    (default 1.1*pi, m3d_aggregator.cpp:30,74-87,95-103), not wall time;
  * the bounding box is an *exclusion* zone: points inside the box around
    the robot are discarded (m3d_aggregator.cpp:65-73);
  * progress is percent-of-rotation with 0.1 resolution, -1 when disarmed
    (m3d_aggregator.cpp:119-124);
  * emitting a cloud disarms the aggregator until a request re-arms it
    (m3d_aggregator.cpp:224-229; ``auto_rearm`` re-arms at once).

The reference's state is functional and donated to each step. Here
``add_line`` updates the state's buffers in place and returns the state
with its new scalars; the state passed in must not be used again. Each
buffer has one spare row past the capacity: a kept point whose slot lies
past the capacity is written there, which is where the reference's
``mode="drop"`` scatter throws it away, so no index leaves the buffer and
no count is read back to the host.

The reference compiles a line into one program. With ``compiled=True``
(the default) a line is one CUDA graph replay on a CUDA device
(``utils.capture.CapturedStep``, cached by the inputs' signature): the
graph updates a state of its own, into which a call copies a state that
is not the graph's (a new one, after ``init_state``, ``emit`` or
``request``), and it writes the new scalars into that state too. On the
CPU the same program runs eagerly. ``add_staged_line`` is the live
chain's line: points, valid flags, intensities and the encoder angle in
one float32 buffer (``stage_line``'s layout, one host-to-device copy),
the line's transform (``FrameChain.base_from_laser``) computed inside the
program. ``emit`` hands the buffers to the cloud and starts a state with
new ones (``compiled``: it copies them, since the graph's state is updated
by the next line), so an emitted cloud never changes under its consumer.
``compiled=False`` runs the program eagerly, with the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.consts import const
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.utils.capture import CapturedStep, signature


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static aggregator configuration.

    ``bb_*`` follow the reference's param names (m3d_aggregator.cpp:164-171,
    defaults +-1 m): the robot self-filter exclusion box in the base frame.
    """

    capacity: int = 262144           # max points per aggregated 3D scan
    line_length: int = 1024          # beams per scan line (padded)
    angular_threshold: float = 1.1 * math.pi
    bb_x_up: float = 1.0
    bb_x_down: float = -1.0
    bb_y_up: float = 1.0
    bb_y_down: float = -1.0
    bb_z_up: float = 1.0
    bb_z_down: float = -1.0
    auto_rearm: bool = True


@dataclasses.dataclass(frozen=True)
class AggregatorState:
    """Device-resident aggregation state. ``points``, ``intensity`` and
    ``mask`` have capacity + 1 rows; the last takes the dropped writes."""

    points: torch.Tensor        # (capacity + 1, 3) float32, PAD_COORD unset
    intensity: torch.Tensor     # (capacity + 1,) float32
    mask: torch.Tensor          # (capacity + 1,) bool
    write_idx: torch.Tensor     # () int32 — next free slot
    angular_distance: torch.Tensor  # () float32 — integrated sweep
    last_quat: torch.Tensor     # (4,) float32 xyzw of the previous line
    has_last: torch.Tensor      # () bool — False until the first line lands
    creating: torch.Tensor      # () bool — armed / disarmed
    dropped: torch.Tensor       # () int32 — points lost to overflow


# the scalars a line updates
_SCALARS = ("write_idx", "angular_distance", "last_quat", "has_last",
            "dropped")


def staged_size(line_length: int) -> int:
    """Floats in a staged line: points (L, 3), valid, intensity (L each),
    the encoder angle."""
    return 5 * line_length + 1


def stage_line(out: np.ndarray, points: np.ndarray, valid: np.ndarray,
               intensity: np.ndarray, angle: float) -> np.ndarray:
    """Write a line of n <= L beams into ``out`` (a float32 array of
    ``staged_size(L)``): the beams padded to L with zeros, valid flags as
    1/0, the angle rounded to float32."""
    L = (out.shape[0] - 1) // 5
    n = points.shape[0]
    out[:] = 0.0
    out[:3 * n] = points.reshape(-1)
    out[3 * L:3 * L + n] = valid
    out[4 * L:4 * L + n] = intensity
    out[5 * L] = angle
    return out


class ScanAggregator:
    """Creates and advances :class:`AggregatorState` on ``device`` (CUDA
    unless the caller asks for the CPU)."""

    def __init__(self, config: AggregatorConfig = AggregatorConfig(),
                 device=None, compiled: bool = True):
        from tpu_slam_torch import default_device

        self.config = config
        self.device = default_device(device)
        self.compiled = compiled
        # captured lines by (program, its static args, the inputs'
        # signature); the values hold what the key names by identity
        self._lines: Dict[Tuple, Tuple] = {}

    def init_state(self, armed: bool = True) -> AggregatorState:
        c, dev = self.config, self.device
        n = c.capacity + 1
        return AggregatorState(
            points=torch.full((n, 3), PAD_COORD, dtype=torch.float32,
                              device=dev),
            intensity=torch.zeros(n, dtype=torch.float32, device=dev),
            mask=torch.zeros(n, dtype=torch.bool, device=dev),
            write_idx=torch.zeros((), dtype=torch.int32, device=dev),
            angular_distance=torch.zeros((), dtype=torch.float32,
                                         device=dev),
            last_quat=const((0.0, 0.0, 0.0, 1.0), torch.float32,
                            dev).clone(),
            has_last=torch.zeros((), dtype=torch.bool, device=dev),
            creating=torch.full((), armed, dtype=torch.bool, device=dev),
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
        )

    def add_line(self, state: AggregatorState, points: torch.Tensor,
                 valid: torch.Tensor, T_base_sensor: torch.Tensor,
                 intensity: Optional[torch.Tensor] = None
                 ) -> AggregatorState:
        """Integrate one scan line.

        Args:
          state: current state (consumed: its buffers are updated in place).
          points: (line_length, 3) float32 sensor-frame points.
          valid: (line_length,) bool — real beams.
          T_base_sensor: (4, 4) base<-sensor transform at the line's stamp
            (m3d_aggregator.cpp:261-262).
          intensity: optional (line_length,) float32.
        """
        if intensity is None:
            intensity = torch.zeros(points.shape[0], dtype=torch.float32,
                                    device=points.device)
        args = (points, valid, T_base_sensor, intensity)
        if not self.compiled:
            return _add_line(state, *args, self.config)
        return self._run(_line_in_place, state, args, ())

    def add_staged_line(self, state: AggregatorState, staged: torch.Tensor,
                        chain) -> AggregatorState:
        """Integrate one line staged by ``stage_line`` (a (staged_size(L),)
        float32 tensor on the device) at ``chain.base_from_laser`` of its
        angle, both in one program: the live chain's line. ``state`` is
        consumed as in ``add_line``."""
        if not self.compiled:
            return _staged_line(state, staged, chain, self.config)
        return self._run(_staged_line, state, (staged,), (chain,))

    def _run(self, program, state, args, static):
        """``program(state, *args, *static, config)`` updating ``state``:
        a replay of its captured step on a CUDA device, eager on the
        CPU."""
        if state.points.device.type != "cuda":
            return program(state, *args, *static, self.config)
        key = (program, tuple(id(s) for s in static),
               signature((state, tuple(args))))
        hit = self._lines.get(key)
        if hit is None:
            step = CapturedStep(
                lambda st, *a: program(st, *a, *static, self.config),
                state, args)
            hit = self._lines[key] = (step, static)
        return hit[0](state, *args)

    def ready(self, state: AggregatorState) -> torch.Tensor:
        return state.angular_distance > self.config.angular_threshold

    def progress(self, state: AggregatorState) -> torch.Tensor:
        """Percent of rotation, 0.1 resolution; -1 when disarmed
        (m3d_aggregator.cpp:119-124)."""
        pct = 0.1 * torch.floor(
            state.angular_distance * 1000.0 / self.config.angular_threshold)
        return torch.where(state.creating, pct, -1.0)

    def emit(self, state: AggregatorState
             ) -> Tuple[PointCloud, AggregatorState]:
        """The aggregated cloud, and a cleared state with buffers of its
        own (m3d_aggregator.cpp:188-223,108-114); the new state is disarmed
        unless ``auto_rearm``."""
        c = self.config.capacity
        cloud = PointCloud(points=state.points[:c], mask=state.mask[:c],
                           attrs=state.intensity[:c, None])
        if self.compiled:
            cloud = PointCloud(points=cloud.points.clone(),
                               mask=cloud.mask.clone(),
                               attrs=cloud.attrs.clone())
        return cloud, self.init_state(armed=self.config.auto_rearm)

    def request(self, state: AggregatorState) -> AggregatorState:
        """Re-arm (clear + create), the reference's request topic."""
        return self.init_state(armed=True)


def _add_line(state: AggregatorState, points: torch.Tensor,
              valid: torch.Tensor, T: torch.Tensor, intensity: torch.Tensor,
              config: AggregatorConfig) -> AggregatorState:
    L = points.shape[0]
    C = config.capacity
    pts_base = se3.apply(T, points)

    # Exclusion box: keep the points OUTSIDE (m3d_aggregator.cpp:65-73).
    x, y, z = pts_base[:, 0], pts_base[:, 1], pts_base[:, 2]
    inside = ((x <= config.bb_x_up) & (x >= config.bb_x_down)
              & (y <= config.bb_y_up) & (y >= config.bb_y_down)
              & (z <= config.bb_z_up) & (z >= config.bb_z_down))
    keep = valid & ~inside & state.creating

    # Compact the line's kept points to its front (a stable sort on an
    # integer key: kept rows first, each group in line order).
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    pts_c = pts_base[order]
    keep_c = keep[order]
    int_c = intensity[order]
    n_keep = keep_c.sum(dtype=torch.int32)

    # Kept rows past the capacity, and the rows not kept, go to the spare
    # row C.
    idx = state.write_idx + torch.arange(L, dtype=torch.int32,
                                         device=points.device)
    slot = torch.where(keep_c & (idx < C), idx, C).long()
    state.points.index_put_((slot,), pts_c)
    state.intensity.index_put_((slot,), int_c)
    state.mask.index_put_((slot,), keep_c)
    new_write = torch.clamp(state.write_idx + n_keep, max=C)
    n_dropped = state.write_idx + n_keep - new_write

    # Integrate the quaternion angular distance of the line's rotation
    # (m3d_aggregator.cpp:74-87), only while armed; the first line latches.
    q = se3.quat_from_matrix(T[:3, :3])
    d = se3.quat_angle_between(q, state.last_quat)
    d = torch.where(torch.isnan(d), 0.0, d)
    inc = torch.where(state.creating & state.has_last, d, 0.0)

    return dataclasses.replace(
        state,
        write_idx=new_write,
        angular_distance=state.angular_distance + inc,
        last_quat=torch.where(state.creating, q, state.last_quat),
        has_last=state.has_last | state.creating,
        dropped=state.dropped + n_dropped,
    )


def _line_in_place(state: AggregatorState, points: torch.Tensor,
                   valid: torch.Tensor, T: torch.Tensor,
                   intensity: torch.Tensor,
                   config: AggregatorConfig) -> AggregatorState:
    """``_add_line`` with the new scalars written into ``state``'s own
    (a captured line updates one state)."""
    new = _add_line(state, points, valid, T, intensity, config)
    for name in _SCALARS:
        getattr(state, name).copy_(getattr(new, name))
    return state


def _staged_line(state: AggregatorState, staged: torch.Tensor, chain,
                 config: AggregatorConfig) -> AggregatorState:
    """A staged line at ``chain.base_from_laser`` of its angle."""
    L = config.line_length
    return _line_in_place(state, staged[:3 * L].view(L, 3),
                          staged[3 * L:4 * L] != 0,
                          chain.base_from_laser(staged[5 * L]),
                          staged[4 * L:5 * L], config)
