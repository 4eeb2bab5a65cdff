"""Run scan-to-map odometry over a recorded sequence.

    python -m tpu_slam_torch.cli.run_odometry --bag seq.bag --engine dense \
        --bag-gt-frame odom --set ndt.window_dims=192,192,32 --json

Port of ``tpu_slam.cli.run_odometry``: ``--engine sparse`` (the default)
runs the sparse voxel-map engine ``LidarOdometry``, ``--engine dense`` the
dense-window engine. A bag is first converted into an npz dataset beside
it (``<bag>.dataset``); the summary then carries the seconds of that
conversion (``bag_convert_s``) and of the odometry run (``odometry_s``).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from tpu_slam_torch.cli.common import add_common_args, apply_overrides, emit
from tpu_slam_torch.ingest.dataset import DatasetReader
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.metrics import ate_rmse, rpe_rmse


def _clouds_from_dataset(reader, capacity, device):
    from tpu_slam_torch.core.pointcloud import PointCloud
    for rec in reader:
        yield PointCloud.from_points_host(rec.points[rec.mask],
                                          capacity=capacity, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="npz dataset directory")
    src.add_argument("--bag", help="rosbag V2.0 file (PointCloud2 scans; "
                     "converted next to the bag first)")
    p.add_argument("--bag-topic", default=None,
                   help="PointCloud2 topic (default: first found)")
    p.add_argument("--bag-gt-frame", default=None,
                   help="TF parent frame to attach as ground truth")
    p.add_argument("--out", default=None, help="trajectory output .npz")
    p.add_argument("--input-capacity", type=int, default=32768)
    p.add_argument("--engine", choices=["sparse", "dense"],
                   default="sparse",
                   help="odometry engine: 'sparse' is the voxel-map engine "
                        "(LidarOdometry); 'dense' the moment-window engine "
                        "(needs --set ndt.window_dims=Wx,Wy,Wz)")
    add_common_args(p)
    args = p.parse_args(argv)

    from tpu_slam_torch import default_device

    device = default_device(args.device)
    cfg = apply_overrides(OdometryConfig(), args.set)
    if args.engine == "dense":
        from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
        odo = DenseLidarOdometry(cfg, device=device)
    else:
        from tpu_slam_torch.pipeline.odometry import LidarOdometry
        odo = LidarOdometry(cfg, device=device)
    dataset = args.dataset
    timing = {}
    if args.bag:
        from tpu_slam_torch.ingest.rosbag import bag_to_dataset
        t0 = time.perf_counter()
        dataset = bag_to_dataset(args.bag, args.bag + ".dataset",
                                 cloud_topic=args.bag_topic,
                                 gt_frame=args.bag_gt_frame)
        timing["bag_convert_s"] = time.perf_counter() - t0
    reader = DatasetReader(dataset)
    gt = reader.gt_poses()
    init = gt[0] if gt is not None else None
    t0 = time.perf_counter()
    poses, log = odo.run(_clouds_from_dataset(reader, args.input_capacity,
                                              device), init_pose=init)
    timing["odometry_s"] = time.perf_counter() - t0

    summary = dict(log.summary())
    if gt is not None:
        summary["ate_rmse_m"] = ate_rmse(poses, gt, align=False)
        rpe_t, rpe_r = rpe_rmse(poses, gt)
        summary["rpe_trans_m"] = rpe_t
        summary["rpe_rot_rad"] = rpe_r
    summary.update(timing)
    if args.out:
        np.savez_compressed(args.out, poses=poses,
                            metrics=[m.to_json() for m in log.records])
        summary["trajectory"] = args.out
    emit(summary, args.json)


if __name__ == "__main__":
    main()
