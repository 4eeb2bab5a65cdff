"""Checkpoint / resume of the SLAM state, on either odometry engine.

One ``.npz`` holding every array of ``pipeline.state.slam_state_to_numpy``
(the dense engine's windows or the host engine's voxel map, the occupancy
layer or grid when it is on, pose graph, keyframe buffers, counters, loop
bookkeeping) plus a JSON manifest. The manifest names this package's own
format and its version and the odometry engine, so a file of another
format, or of an engine the loading system does not run, is refused
instead of being half-read. Files written by ``tpu_slam`` are such files:
their layout differs and they are not read.

The host engine's checkpoint carries its occupancy grid. (The reference's
saves only pose, last delta and the map, and resumes with no grid, so a
resumed run with occupancy on fails or starts its evidence over.)

A resumed run reproduces the uninterrupted run's poses exactly: the state
is stored bit for bit, including the host mirror of the newest keyframe
pose that the keyframe test reads.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from tpu_slam_torch.pipeline.state import (slam_state_from_numpy,
                                           slam_state_to_numpy)

FORMAT = "tpu_slam_torch.slam"
FORMAT_VERSION = 1
ENGINES = ("host", "dense")


def _engine_of(state) -> str:
    from tpu_slam_torch.pipeline.odometry import OdometryState

    return "host" if isinstance(state.odom, OdometryState) else "dense"


def save_checkpoint(path: str, state, scan_index: int = -1) -> str:
    """Write the SLAM state to ``path`` (.npz appended when missing).
    ``scan_index`` records how many scans the state has consumed (default:
    the odometry's own count). Returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = slam_state_to_numpy(state)
    odom = state.odom
    engine = _engine_of(state)
    manifest = {
        "format": FORMAT, "format_version": FORMAT_VERSION,
        "engine": engine,
        "dims": (list(odom.grid.dims) if engine == "dense"
                 and odom is not None else None),
        "scan_index": int(odom.scan_index if scan_index < 0 and odom
                          is not None else scan_index),
    }
    np.savez_compressed(path, manifest=json.dumps(manifest), **arrays)
    return path


def load_checkpoint(path: str, device=None) -> Tuple[object, dict]:
    """Load a checkpoint onto ``device`` (CUDA unless the caller asks for
    the CPU); returns (SLAMState, manifest dict; its ``engine`` names the
    odometry engine the state belongs to)."""
    from tpu_slam_torch import default_device

    dev = default_device(device)
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        got = (manifest.get("format"), manifest.get("format_version"),
               manifest.get("engine"))
        if got[:2] != (FORMAT, FORMAT_VERSION) or got[2] not in ENGINES:
            raise ValueError(f"{path}: checkpoint format {got} is not "
                             f"{(FORMAT, FORMAT_VERSION)} of an engine in "
                             f"{ENGINES}")
        arrays = {k: z[k] for k in z.files if k != "manifest"}
    dims = tuple(manifest["dims"]) if manifest["dims"] is not None else None
    return slam_state_from_numpy(arrays, dims, dev), manifest
