"""Generate a synthetic recorded sequence (the rosbag-record replacement).

    python -m tpu_slam_torch.cli.make_dataset --out seq --n-scans 40

Port of ``tpu_slam.cli.make_dataset``: simulates a VLP-16 on a trajectory
through the office world and writes a DatasetReader-compatible directory
with ground-truth poses. The rays are cast on ``--device`` (CUDA unless
``--device cpu``); the output is the same on either.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from tpu_slam_torch.cli.common import add_common_args, emit
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.ingest.dataset import DatasetWriter, ScanRecord


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True, help="output dataset directory")
    p.add_argument("--n-scans", type=int, default=40)
    p.add_argument("--trajectory", choices=["loop", "arc"], default="loop")
    p.add_argument("--radius", type=float, default=2.5)
    p.add_argument("--n-azimuth", type=int, default=600)
    p.add_argument("--noise", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    add_common_args(p)
    args = p.parse_args(argv)

    from tpu_slam_torch import default_device

    device = default_device(args.device)
    world = syn.default_office()
    rng = np.random.default_rng(args.seed)
    writer = DatasetWriter(args.out, meta={
        "sensor": "VLP16", "n_azimuth": args.n_azimuth,
        "trajectory": args.trajectory, "noise": args.noise,
    })
    frac = 1.0 if args.trajectory == "loop" else 0.25
    n = args.n_scans
    for k in range(n):
        a = 2 * math.pi * frac * k / max(n - 1, 1)
        T = syn.se2_pose(args.radius * math.cos(a),
                         args.radius * math.sin(a), a + math.pi / 2, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=args.n_azimuth, noise_std=args.noise,
            rng=rng, device=device)
        writer.append(ScanRecord(points=pts[valid],
                                 mask=np.ones(valid.sum(), bool),
                                 intensity=None, stamp=float(k),
                                 gt_pose=T))
    emit({"dataset": args.out, "n_scans": n}, args.json)


if __name__ == "__main__":
    main()
