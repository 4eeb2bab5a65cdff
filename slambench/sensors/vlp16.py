"""``vlp16``: a Velodyne VLP-16, 16 rings from -15 to +15 degrees in its
firing order (``tpu_slam_torch.ingest.synthetic``'s VLP-16 model)."""

from __future__ import annotations

from slambench.world import ring_scans

ELEVATIONS_DEG = (-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13,
                  -1, 15)


def scans(patches, poses, sensor, seed, device):
    return ring_scans(patches, poses, sensor, seed, device, ELEVATIONS_DEG)
