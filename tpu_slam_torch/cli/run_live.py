"""Run the composed live pipeline against real (or simulated) devices.

    python -m tpu_slam_torch.cli.run_live --lms-host 192.168.0.10 \
        --m3d-host 192.168.0.11 --speed 12 --scans 10
    python -m tpu_slam_torch.cli.run_live --lms-host 192.168.0.10 \
        --m3d-serial /dev/ttyUSB0 --speed 12 --device cpu

Port of ``tpu_slam.cli.run_live``, the bringup twin of universal.launch +
m3d_husky_bringup.launch: connects the SICK scanner (TCP, CoLa-A) and the
rotating unit (TCP or serial), commands the rotation speed, streams scan
lines through the aggregation chain into SLAM, printing one JSON line per
emitted 3D scan, and stops the unit on the way out. Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpu_slam_torch.cli.common import add_common_args, apply_overrides, emit
from tpu_slam_torch.ingest.aggregator import AggregatorConfig
from tpu_slam_torch.ingest.frames import Calibration, FrameChain, SensorModel
from tpu_slam_torch.ingest.native import NativeLms, NativeM3d
from tpu_slam_torch.pipeline.config import SLAMConfig
from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lms-host", required=True)
    p.add_argument("--lms-port", type=int, default=2111)
    p.add_argument("--m3d-host", default=None)
    p.add_argument("--m3d-port", type=int, default=10001)
    p.add_argument("--m3d-serial", default=None,
                   help="serial device path (57600 baud) instead of TCP")
    p.add_argument("--speed", type=int, default=12,
                   help="rotation speed command (universal.launch:17)")
    p.add_argument("--sensor", default="LMS100",
                   choices=sorted(["TIM500", "LMS100", "LMS100C", "VLP16"]))
    p.add_argument("--calibration", default=None,
                   help="m3d_calibration.yaml path (default: $ROS_HOME)")
    p.add_argument("--scans", type=int, default=None,
                   help="stop after N emitted 3D scans")
    p.add_argument("--no-slam", action="store_true",
                   help="aggregate only (the reference's aggregator-only "
                        "bringup)")
    add_common_args(p)
    args = p.parse_args(argv)

    from tpu_slam_torch import default_device
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    device = default_device(args.device)
    slam_cfg = apply_overrides(SLAMConfig(), args.set)
    live_cfg = LiveConfig(
        sensor_model=args.sensor,
        aggregator=AggregatorConfig(line_length=1024))
    chain = FrameChain(sensor=SensorModel.by_name(args.sensor),
                       calibration=Calibration.load(args.calibration))
    slam = None if args.no_slam else SLAMSystem(slam_cfg, device=device)
    pipe = LivePipeline(live_cfg, chain=chain, slam=slam, device=device)
    # builds and first-use initialisation before the scanner streams
    pipe.warm_up()

    m3d = NativeM3d()
    lms = NativeLms(cap=live_cfg.line_capacity)
    try:
        if args.m3d_serial:
            m3d.connect_serial(args.m3d_serial)
        elif args.m3d_host:
            m3d.connect_tcp(args.m3d_host, args.m3d_port)
        else:
            raise SystemExit("need --m3d-host or --m3d-serial")
        m3d.set_speed(args.speed)
        lms.connect(args.lms_host, args.lms_port)
        lms.start_scan()

        def on_scan(cloud, metrics):
            rec = {"n_points": int(cloud.mask.sum())}
            if metrics is not None:
                rec.update(dataclasses.asdict(metrics))
            print(json.dumps(rec), flush=True)

        results = pipe.run(lms, angle_source=m3d.angle,
                           max_scans=args.scans, on_scan=on_scan)
        emit({"n_scans": len(results), "lines": pipe.lines,
              "dropped_lines": pipe.dropped_lines}, args.json)
    finally:
        try:
            m3d.set_speed(0)
        except ConnectionError:
            pass
        lms.close()
        m3d.close()


if __name__ == "__main__":
    main()
