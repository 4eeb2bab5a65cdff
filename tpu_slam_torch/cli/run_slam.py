"""Run the full 6D SLAM pipeline over a recorded sequence.

    python -m tpu_slam_torch.cli.run_slam --dataset seq --out result \
        --checkpoint ckpt --checkpoint-every 10 --json

Port of ``tpu_slam.cli.run_slam``: SLAMSystem over a DatasetReader
directory, a checkpoint every K scans and resume from one. Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_slam_torch.cli.common import add_common_args, apply_overrides, emit
from tpu_slam_torch.ingest.dataset import DatasetReader
from tpu_slam_torch.pipeline.config import SLAMConfig
from tpu_slam_torch.pipeline.metrics import ate_rmse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default=None, help="output dir (trajectory, map)")
    p.add_argument("--checkpoint", default=None, help="checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save checkpoint every K scans (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    p.add_argument("--input-capacity", type=int, default=32768)
    add_common_args(p)
    args = p.parse_args(argv)

    from tpu_slam_torch import default_device
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    device = default_device(args.device)
    cfg = apply_overrides(SLAMConfig(), args.set)
    reader = DatasetReader(args.dataset)
    slam = SLAMSystem(cfg, device=device)

    gt = reader.gt_poses()
    start = 0
    if args.resume:
        if not (args.checkpoint and os.path.exists(args.checkpoint)):
            raise SystemExit("--resume requires an existing --checkpoint")
        state, manifest = load_checkpoint(args.checkpoint, device=device)
        start = manifest["scan_index"]
    else:
        state = slam.init_state(gt[0] if gt is not None else None)

    poses = []
    for k in range(start, len(reader)):
        rec = reader[k]
        cloud = PointCloud.from_points_host(
            rec.points[rec.mask], capacity=args.input_capacity,
            device=device)
        state, _ = slam.step(state, cloud)
        poses.append(state.odom.pose.cpu().numpy())
        if (args.checkpoint and args.checkpoint_every
                and (k + 1) % args.checkpoint_every == 0):
            save_checkpoint(args.checkpoint, state, scan_index=k + 1)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, scan_index=len(reader))

    poses = np.stack(poses) if poses else np.zeros((0, 4, 4))
    summary = dict(slam.metrics.summary())
    summary.update(n_keyframes=state.n_keyframes,
                   n_loop_closures=state.n_loop_closures)
    if gt is not None and start == 0 and len(poses) == len(reader):
        summary["ate_rmse_m"] = ate_rmse(poses, gt, align=False)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez_compressed(os.path.join(args.out, "trajectory.npz"),
                            poses=poses)
        vmap = state.odom.vmap
        np.savez_compressed(
            os.path.join(args.out, "map.npz"),
            keys=vmap.keys.cpu().numpy(), count=vmap.count.cpu().numpy(),
            sum_pts=vmap.sum_pts.cpu().numpy())
        summary["out"] = args.out
    emit(summary, args.json)


if __name__ == "__main__":
    main()
