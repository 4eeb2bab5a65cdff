"""``rounded_rect``: laps of a rounded rectangle (the corridor route of
``tpu_slam_torch.ingest.synthetic.corridor_route``, which a city lap
shares with another centre, size and step)."""

from __future__ import annotations

import math

import numpy as np

from slambench.world import se2_pose


def poses(n: int, half=(12.0, 8.0), corner_radius: float = 3.0,
          z: float = 1.2, center=(0.0, 0.0), step: float = 0.0,
          lap_scans: int = 0, speed_var: float = 0.0) -> np.ndarray:
    """(n, 4, 4) poses along a rounded rectangle, counter-clockwise from
    the south leg heading east (``corridor_route``'s path, moved to
    ``center``). The step is ``step``, or the lap divided into
    ``lap_scans`` equal steps; ``speed_var`` modulates it sinusoidally by
    +- that fraction (period 23 scans)."""
    hx, hy = half
    r = corner_radius
    cx, cy = center
    lx, ly = 2 * (hx - r), 2 * (hy - r)
    qa = math.pi / 2 * r
    per = 2 * lx + 2 * ly + 4 * qa
    if lap_scans:
        step = per / lap_scans
    poses = []
    s_acc = 0.0
    for k in range(n):
        if k > 0:
            s_acc += step * (1.0 + speed_var * math.sin(2 * math.pi * k
                                                        / 23.0))
        s = s_acc % per
        legs = ((lx, lambda s: (-hx + r + s, -hy, 0.0)),
                (qa, lambda s: (hx - r + r * math.sin(s / r),
                                -hy + r * (1 - math.cos(s / r)), s / r)),
                (ly, lambda s: (hx, -hy + r + s, math.pi / 2)),
                (qa, lambda s: (hx - r * (1 - math.cos(s / r)),
                                hy - r + r * math.sin(s / r),
                                math.pi / 2 + s / r)),
                (lx, lambda s: (hx - r - s, hy, math.pi)),
                (qa, lambda s: (-hx + r - r * math.sin(s / r),
                                hy - r * (1 - math.cos(s / r)),
                                math.pi + s / r)),
                (ly, lambda s: (-hx, hy - r - s, 1.5 * math.pi)),
                (math.inf, lambda s: (-hx + r * (1 - math.cos(s / r)),
                                      -hy + r - r * math.sin(s / r),
                                      1.5 * math.pi + s / r)))
        for length, at in legs:
            if s < length:
                x, y, yaw = at(s)
                break
            s -= length
        poses.append(se2_pose(cx + x, cy + y, yaw, z))
    return np.stack(poses)
