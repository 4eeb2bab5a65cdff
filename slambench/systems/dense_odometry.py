"""``DenseLidarOdometry.step``, fed one scan at a time.

The timed call is one ``step`` and the copy of its pose to the host. The
step's metrics row (iterations, matched fraction, accepted, inserted,
coarse fraction) stays on the device and is read once the window has
closed. The check replays every step of the run through the reference's
own windows at the poses the program returned, and at a sample of the
window's scans drawn from the seed registers the scan itself from the
same prediction and windows: the program's pose there has to be the
reference's (the median and the 80th percentile of the gaps over the
sample), and so do its accept and insert decisions.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from slambench.systems import from_json


class Driver:
    def __init__(self, config: Dict, device):
        from tpu_slam_torch.pipeline.config import OdometryConfig
        from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

        self.config = config
        self.engine = DenseLidarOdometry(
            from_json(OdometryConfig(), config["odometry"]), device=device,
            compiled=config["compiled"])
        self.state = None
        self.src: List[int] = []            # scan index of each step
        self.poses: List[np.ndarray] = []   # the pose each step returned
        self.rows: List[torch.Tensor] = []  # each step's metrics row

    def start(self, cloud, index: int, init_pose: np.ndarray) -> None:
        self.state = self.engine.init_state(cloud, init_pose)
        self.src.append(index)
        self.poses.append(self.state.pose.cpu().numpy())
        self.rows.append(self.state.last_metrics)

    def step(self, cloud, index: int) -> np.ndarray:
        self.state = self.engine.step(self.state, cloud)
        pose = self.state.pose.cpu().numpy()
        self.src.append(index)
        self.poses.append(pose)
        self.rows.append(self.state.last_metrics)
        return pose

    def warm(self) -> None:
        """Nothing beyond the set-up steps: the first step captures."""

    def counters(self) -> Dict[str, float]:
        return {}

    def release(self) -> Dict:
        """Free the program's state; returns the run's record."""
        flags = torch.stack(self.rows[1:]).cpu().numpy()
        record = dict(src=list(self.src), poses=np.stack(self.poses),
                      accepted=np.r_[True, flags[:, 2] > 0.5],
                      inserted=np.r_[True, flags[:, 3] > 0.5])
        self.engine = self.state = None
        self.rows = []
        return record


def check(config: Dict, pts: torch.Tensor, msk: torch.Tensor,
          record: Dict, window_from: int, seed: int,
          device) -> Dict[str, float]:
    """The numbers compared (``odometry_numbers``)."""
    return odometry_numbers(config["odometry"], config["check"], pts, msk,
                            record, window_from, seed, device)


def odometry_numbers(odometry: Dict, chk: Dict, pts, msk, record: Dict,
                     window_from: int, seed: int, device) -> Dict[str, float]:
    """``pose_gap_p50_mm`` and ``rot_gap_p50_mrad``: the median, over
    ``chk['sample_scans']`` window scans drawn from the seed, of the gap
    between the program's pose and the reference's, and ``..._p80_...``
    their 80th percentile (quantiles, because on some scans the kernel's
    summation order flips an LM accept on nearly equal costs and moves a
    pose by 0.1-5 mm, while a fault moves every scan it touches: the
    median holds a fault on half the scans, the 80th percentile one on a
    fifth, less the share that flips); ``gate_mismatches``: sampled scans
    whose accept or insert decision differs; ``nonfinite_poses``: window
    poses with a non-finite entry. Each sample's gaps go to
    ``record['info']``, with the seconds the replay and the sampled
    registrations took."""
    from slambench.reference.odometry import DenseOdometryReference, pose_gap
    from slambench.reference.pointcloud import PointCloud

    sample = sample_steps(len(record["src"]), window_from,
                          chk["sample_scans"], seed)
    ref = DenseOdometryReference(odometry, device)
    t0 = time.perf_counter()
    gaps, register_s = replay_odometry(ref, pts, msk, record, sample,
                                       PointCloud, pose_gap)
    info = record.setdefault("info", {})
    info["sampled_gaps"] = [[i, 1e3 * g[0], 1e3 * g[1]]
                            for i, g in zip(sample, gaps)]
    info["check_replay_s"] = time.perf_counter() - t0
    info["check_register_s"] = register_s
    window = record["poses"][window_from:]
    dt = np.asarray([g[0] for g in gaps])
    dr = np.asarray([g[1] for g in gaps])
    return dict(
        pose_gap_p50_mm=1e3 * float(np.median(dt)),
        rot_gap_p50_mrad=1e3 * float(np.median(dr)),
        pose_gap_p80_mm=1e3 * float(np.quantile(dt, 0.8)),
        rot_gap_p80_mrad=1e3 * float(np.quantile(dr, 0.8)),
        gate_mismatches=float(sum(g[2] for g in gaps)),
        nonfinite_poses=float(np.sum(~np.isfinite(window).all(axis=(1, 2)))))


def sample_steps(n_steps: int, window_from: int, k: int, seed: int
                 ) -> List[int]:
    """k window steps drawn from the seed, the window's last among them."""
    rng = np.random.default_rng(seed)
    pool = np.arange(window_from, n_steps - 1)
    pick = rng.choice(pool, size=min(k - 1, pool.size), replace=False)
    return sorted(set(int(i) for i in pick) | {n_steps - 1})


def replay_odometry(ref, pts, msk, record, sample, cloud_cls, pose_gap):
    """Every step again through ``ref`` at the recorded poses; at the
    ``sample`` steps the reference's own registration is compared. Returns
    (translation gap, rotation gap, decision differs) for each, and the
    seconds those steps took."""
    src = record["src"]
    # one copy of every pose: a copy a step would wait for the device
    P = torch.as_tensor(record["poses"], device=ref.device)

    def cloud(i):
        return cloud_cls(points=pts[src[i]], mask=msk[src[i]])

    def pose(i):
        return P[i]

    ref.start(cloud(0), pose(0))
    want = set(sample)
    out, register_s = [], 0.0
    for i in range(1, len(src)):
        if i in want:
            _sync(ref.device)
            t0 = time.perf_counter()
        mine = ref.follow(cloud(i), pose(i), bool(record["inserted"][i]),
                          register=i in want)
        if i in want:
            _sync(ref.device)
            register_s += time.perf_counter() - t0
        if mine is not None:
            dt, dr = pose_gap(mine.T, pose(i))
            differs = (mine.accepted != bool(record["accepted"][i])
                       or mine.inserted != bool(record["inserted"][i]))
            if not (np.isfinite(dt) and np.isfinite(dr)):
                dt = dr = float("inf")
            out.append((dt, dr, differs))
    return out, register_s


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
