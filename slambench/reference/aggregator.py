"""Plain re-computation of the rotating unit's line-to-point assembly.

The m3d chain as the reference stack wires it (universal.launch): an
LMS100 line of ranges at its beam angles (``lms_poller.cpp:74``'s
startAngle), each line carried into the unit's base frame by the frame
chain at the line's encoder angle (``encoder_node_li.cpp:87-109`` and
``transformBroadcaster.py:126-141``), the points inside the ±1 m
self-filter box dropped (``m3d_aggregator.cpp:65-73``) and the lines
gathered until the integrated rotation passes 1.1 pi
(``m3d_aggregator.cpp:74-103``). A whole stop's lines are handled at once.

Departures from the port (``tpu_slam_torch.ingest.aggregator``,
``ingest.frames``, ``pipeline.live``): the transforms are built in float64
from the closed form of RPY(0, -pi/2, angle - pi) and cast to float32 (the
port composes float32 quaternions); a stop's lines are transformed in one
batch and the kept points taken in line order by a mask (the port scatters
each line into a fixed buffer of 262,144 rows); the trigger integrates the
float64 angle between consecutive lines' rotations (the port integrates
the float32 quaternion angle). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# the LMS100's mounting offset on the rotating link (transformBroadcaster.py
# :10-19; identity rotation) and the link's lever arm on the unit base
# (encoder_node_li.cpp:89-90)
LMS100_MOUNT = (0.074, 0.0, 0.068)
ROT_LINK = (-0.0835, 0.0, 0.1835)
# the encoder's homing offset subtracted from its angle
# (encoder_node_li.cpp:41-43,98)
ENCODER_OFFSET = math.pi


def base_from_laser(angles: np.ndarray) -> np.ndarray:
    """(L,) encoder angles (rad) -> (L, 4, 4) float64 base <- laser
    transforms: Rz(a - pi) Ry(-pi/2) about the lever arm, then the
    LMS100's mounting offset."""
    a = np.asarray(angles, np.float64) - ENCODER_OFFSET
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(a), np.ones_like(a)
    # Rz(a) @ Ry(-pi/2): Ry(-pi/2) = [[0, 0, -1], [0, 1, 0], [1, 0, 0]]
    R = np.stack([np.stack([z, -s, -c], -1),
                  np.stack([z, c, -s], -1),
                  np.stack([o, z, z], -1)], -2)
    T = np.zeros(a.shape + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.asarray(ROT_LINK) + R @ np.asarray(LMS100_MOUNT)
    T[..., 3, 3] = 1.0
    return T


def beam_directions(n_beams: int, start_deg: float, step_deg: float
                    ) -> np.ndarray:
    """(n, 3) float32 unit directions of the beams in the laser frame."""
    ang = math.radians(start_deg) + math.radians(step_deg) * np.arange(
        n_beams)
    return np.stack([np.cos(ang), np.sin(ang), np.zeros(n_beams)],
                    axis=1).astype(np.float32)


def scan_lines(n_lines: int, angular_threshold: float, step: float,
               start: float = 0.0) -> int:
    """Lines of one 3D scan when consecutive lines are ``step`` rad of
    encoder apart: the first latches, and the scan is complete at the
    first line whose integrated rotation passes the threshold (None of
    ``n_lines`` does: 0)."""
    T = base_from_laser(start + step * np.arange(n_lines))
    R = T[:, :3, :3]
    rel = np.einsum("kji,kjl->kil", R[:-1], R[1:])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    total = np.cumsum(np.arccos(cos))
    done = np.nonzero(total > angular_threshold)[0]
    return int(done[0]) + 2 if done.size else 0


def assemble(ranges: np.ndarray, angles: np.ndarray, dirs: np.ndarray,
             range_min: float, range_max: float, box: Tuple[float, ...],
             device) -> torch.Tensor:
    """One scan's cloud: (K, 3) float32 base-frame points on ``device``,
    the kept returns of every line in line order, beam order within a
    line. ``ranges`` (L, n) float32 m, ``angles`` (L,) rad, ``box`` the
    self-filter (x_down, x_up, y_down, y_up, z_down, z_up)."""
    dev = torch.device(device)
    r = torch.as_tensor(np.asarray(ranges, np.float32), device=dev)
    d = torch.as_tensor(dirs, device=dev)
    T = torch.as_tensor(base_from_laser(angles), dtype=torch.float32,
                        device=dev)
    pts = d[None] * r[..., None]                                # (L, n, 3)
    base = (pts[..., None, :] * T[:, None, :3, :3]).sum(-1) \
        + T[:, None, :3, 3]
    x, y, z = base[..., 0], base[..., 1], base[..., 2]
    xd, xu, yd, yu, zd, zu = box
    inside = ((x <= xu) & (x >= xd) & (y <= yu) & (y >= yd)
              & (z <= zu) & (z >= zd))
    keep = (r >= range_min) & (r <= range_max) & ~inside
    return base[keep]
