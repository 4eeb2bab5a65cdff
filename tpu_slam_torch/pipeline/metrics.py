"""Trajectory metrics (ATE / RPE) and the per-scan metrics stream.

Copy of ``tpu_slam.pipeline.metrics`` (numpy only), with a Stopwatch that
synchronises a CUDA device before reading the clock.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ScanMetrics:
    """Telemetry of one odometry/SLAM step."""

    scan_index: int
    iterations: int
    residual: float
    matched_fraction: float
    wall_time_s: float
    translation_delta: float = 0.0
    rotation_delta: float = 0.0
    is_keyframe: bool = False
    n_loop_closures: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class MetricsLog:
    """Append-only metrics stream with summary statistics."""

    def __init__(self):
        self.records: List[ScanMetrics] = []

    def append(self, m: ScanMetrics):
        self.records.append(m)

    def summary(self) -> dict:
        if not self.records:
            return {}
        wt = np.array([m.wall_time_s for m in self.records])
        return {
            "n_scans": len(self.records),
            "mean_wall_time_s": float(wt.mean()),
            "p50_wall_time_s": float(np.percentile(wt, 50)),
            "p95_wall_time_s": float(np.percentile(wt, 95)),
            "scans_per_sec": float(1.0 / max(wt.mean(), 1e-12)),
            "mean_iterations": float(np.mean(
                [m.iterations for m in self.records])),
            "mean_matched_fraction": float(np.mean(
                [m.matched_fraction for m in self.records])),
            "n_keyframes": sum(m.is_keyframe for m in self.records),
            "n_loop_closures": sum(m.n_loop_closures for m in self.records),
        }


def umeyama_alignment(est: np.ndarray, gt: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares SE(3) alignment est -> gt over (N, 3) positions.

    Returns (R, t) minimizing ||R est + t - gt||^2 (no scale).
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    cov = (gt - mu_g).T @ (est - mu_e) / est.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of positions), optionally aligned.

    est_poses, gt_poses: (N, 4, 4).
    """
    est = est_poses[:, :3, 3]
    gt = gt_poses[:, :3, 3]
    if align and est.shape[0] >= 3:
        R, t = umeyama_alignment(est, gt)
        est = est @ R.T + t
    d = est - gt
    return float(math.sqrt(np.mean(np.sum(d * d, axis=1))))


def rpe_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             delta: int = 1) -> tuple[float, float]:
    """Relative pose error over a fixed frame delta.

    Returns (translational RMSE in m, rotational RMSE in rad).
    """
    n = est_poses.shape[0] - delta
    terr, rerr = [], []
    for k in range(n):
        de = np.linalg.inv(est_poses[k]) @ est_poses[k + delta]
        dg = np.linalg.inv(gt_poses[k]) @ gt_poses[k + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(float(np.dot(e[:3, 3], e[:3, 3])))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(float(np.arccos(c)) ** 2)
    return (float(math.sqrt(np.mean(terr))), float(math.sqrt(np.mean(rerr))))


class Stopwatch:
    """Context-manager wall timer; with a CUDA ``device`` it synchronises
    that device before reading the clock at both ends."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self.t0
        return False
