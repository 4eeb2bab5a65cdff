"""Offline dataset replay — the ROS-bag-free recorded-sequence path.

Copy of ``tpu_slam.ingest.dataset`` (numpy only, the same code) so that
the port imports nothing of ``tpu_slam``; its tests hold what it
writes and decodes byte for byte against the original's.

The reference pipeline replays ROS bags through the node graph (SURVEY.md
§4, universal_velodyne.launch:49,64 pcap arg); here a recorded sequence is a
directory of ``.npz`` files plus a JSON index, and replay is a plain
iterator producing the same aggregated-cloud stream the SLAM layer consumes
(the ``cloud`` topic of m3d_aggregator.cpp:174,188-223).

Format (one file per 3D scan):
  scans/000000.npz:  points (N, 3) f32, mask (N,) bool, intensity (N,) f32
  index.json:        {"scans": [{"file", "stamp", "frame_id", "pose"?}],
                      "meta": {...}}

``pose`` (4x4 row-major, optional) is ground truth for ATE evaluation, not
an input to SLAM.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class ScanRecord:
    """One recorded 3D scan (an aggregated full-rotation cloud)."""

    points: np.ndarray               # (N, 3) float32
    mask: np.ndarray                 # (N,) bool
    intensity: Optional[np.ndarray]  # (N,) float32 or None
    stamp: float
    frame_id: str = "m3d_link"
    gt_pose: Optional[np.ndarray] = None   # (4, 4) world<-base, optional


class DatasetWriter:
    """Record a sequence of 3D scans to a dataset directory."""

    def __init__(self, root: str, meta: Optional[dict] = None):
        self.root = root
        self.scan_dir = os.path.join(root, "scans")
        os.makedirs(self.scan_dir, exist_ok=True)
        self._entries: List[dict] = []
        self._meta = meta or {}

    def append(self, rec: ScanRecord) -> str:
        name = f"{len(self._entries):06d}.npz"
        path = os.path.join(self.scan_dir, name)
        arrays = {"points": rec.points.astype(np.float32),
                  "mask": rec.mask.astype(bool)}
        if rec.intensity is not None:
            arrays["intensity"] = rec.intensity.astype(np.float32)
        np.savez_compressed(path, **arrays)
        entry = {"file": os.path.join("scans", name), "stamp": rec.stamp,
                 "frame_id": rec.frame_id}
        if rec.gt_pose is not None:
            entry["pose"] = np.asarray(rec.gt_pose, float).reshape(16).tolist()
        self._entries.append(entry)
        self.flush()
        return path

    def flush(self):
        with open(os.path.join(self.root, "index.json"), "w") as f:
            json.dump({"scans": self._entries, "meta": self._meta}, f, indent=1)


class DatasetReader:
    """Iterate a recorded sequence of 3D scans."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "index.json")) as f:
            idx = json.load(f)
        self.entries = idx["scans"]
        self.meta = idx.get("meta", {})

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> ScanRecord:
        e = self.entries[i]
        with np.load(os.path.join(self.root, e["file"])) as z:
            points = z["points"]
            mask = z["mask"]
            intensity = z["intensity"] if "intensity" in z.files else None
        pose = None
        if "pose" in e:
            pose = np.asarray(e["pose"], float).reshape(4, 4)
        return ScanRecord(points=points, mask=mask, intensity=intensity,
                          stamp=e["stamp"], frame_id=e.get("frame_id", ""),
                          gt_pose=pose)

    def __iter__(self) -> Iterator[ScanRecord]:
        for i in range(len(self)):
            yield self[i]

    def gt_poses(self) -> Optional[np.ndarray]:
        """(N, 4, 4) ground-truth poses if every scan has one, else None."""
        if not all("pose" in e for e in self.entries):
            return None
        return np.stack([np.asarray(e["pose"], float).reshape(4, 4)
                         for e in self.entries])
