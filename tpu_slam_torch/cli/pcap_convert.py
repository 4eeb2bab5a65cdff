"""Convert a VLP-16 pcap capture into the npz replay dataset.

    python -m tpu_slam_torch.cli.pcap_convert --pcap cap.pcap --out seq

Port of ``tpu_slam.cli.pcap_convert`` (host-side numpy, no device): the
offline twin of the reference's pcap replay (universal_velodyne.launch:
49,64): packets -> revolutions -> one ScanRecord per revolution, which
run_odometry / run_slam consume. Ground-truth poses can be sideloaded from
an .npz with a (N, 4, 4) ``poses`` array.
"""

from __future__ import annotations

import argparse

import numpy as np


def pcap_to_dataset(pcap_path: str, out_root: str, min_range: float = 0.4,
                    max_range: float = 130.0,
                    gt_poses: np.ndarray | None = None,
                    frame_id: str = "velodyne") -> int:
    """Assemble revolutions from ``pcap_path`` into a dataset directory;
    returns the number of scans written. The range gate defaults are
    universal_velodyne.launch:47-48's."""
    from tpu_slam_torch.ingest.dataset import DatasetWriter, ScanRecord
    from tpu_slam_torch.ingest.velodyne import (PACKET_SIZE, VelodyneStream,
                                                read_pcap)

    writer = DatasetWriter(out_root, meta={
        "source": pcap_path, "sensor": "vlp16",
        "min_range": min_range, "max_range": max_range})
    stream = VelodyneStream(min_range=min_range, max_range=max_range)
    n = 0

    def _write(rev) -> None:
        nonlocal n
        if rev.points.shape[0] == 0:
            return
        writer.append(ScanRecord(
            points=rev.points, mask=np.ones(rev.points.shape[0], bool),
            intensity=rev.intensity, stamp=rev.stamp, frame_id=frame_id,
            gt_pose=gt_poses[n] if gt_poses is not None else None))
        n += 1

    batch = []
    for _ts, payload in read_pcap(pcap_path):
        if len(payload) != PACKET_SIZE:
            continue
        batch.append(np.frombuffer(payload, np.uint8))
        if len(batch) >= 64:
            stream.push(np.stack(batch))
            batch = []
        while (rev := stream.pop()) is not None:
            _write(rev)
    if batch:
        stream.push(np.stack(batch))
    while (rev := stream.pop()) is not None:
        _write(rev)
    if (rev := stream.flush()) is not None:
        _write(rev)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pcap", required=True)
    p.add_argument("--out", required=True, help="dataset directory")
    p.add_argument("--min-range", type=float, default=0.4)
    p.add_argument("--max-range", type=float, default=130.0)
    p.add_argument("--gt", default=None,
                   help=".npz with (N,4,4) 'poses' ground truth")
    args = p.parse_args(argv)

    gt = None
    if args.gt:
        with np.load(args.gt) as z:
            gt = z["poses"]
    n = pcap_to_dataset(args.pcap, args.out, min_range=args.min_range,
                        max_range=args.max_range, gt_poses=gt)
    print(f"wrote {n} scans to {args.out}")


if __name__ == "__main__":
    main()
