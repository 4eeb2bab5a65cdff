"""Minimal binary-PLY point-cloud writer (no dependencies).

A copy of ``tpu_slam.utils.ply`` (numpy only). Artifact export for human
verification steps: the reference closed its calibration loop with a PCL
visualizer rendering the two half-clouds red/green for operator
acceptance (m3d_calibration_twiddle.cpp:384-424); a headless machine
exports the same check as a .ply any viewer opens.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None) -> str:
    """Write (N, 3) float points (+ optional (N, 3) uint8 colors) to PLY.

    Binary little-endian; returns the path written.
    """
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(pts.tobytes())
        else:
            col = np.ascontiguousarray(colors, dtype=np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = col
            f.write(rec.tobytes())
    return path


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PLY written by write_ply (round-trip for tests)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        has_color = any("red" in h for h in header)
        if has_color:
            rec = np.frombuffer(f.read(), dtype=[("xyz", np.float32, 3),
                                                 ("rgb", np.uint8, 3)],
                                count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(), dtype=np.float32,
                            count=3 * n).reshape(n, 3)
        return pts.copy(), None
