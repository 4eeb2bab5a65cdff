"""Solve the 5-DoF laser-to-axis extrinsic from a captured rotation.

    python -m tpu_slam_torch.cli.run_calibration --demo --method twiddle
    python -m tpu_slam_torch.cli.run_calibration --input segments.npz \
        --out m3d_calibration.yaml --verify-ply check.ply
    python -m tpu_slam_torch.cli.run_calibration --capture \
        --lms-host 192.168.0.10 --m3d-host 192.168.0.11

Port of ``tpu_slam.cli.run_calibration``. Input: a .npz with ``points``
(S, L, 3), ``valid`` (S, L) and ``transforms`` (S, 4, 4) — the segment
clouds and unit rotation transforms of ``ingest.calibration`` — or a live
capture from the rotating unit (``--capture``), or ``--demo`` for a
synthetic capture. Output: the calibration in the reference's ``[[t],[q]]``
format (transformBroadcaster.py:25-60), a drop-in m3d_calibration.yaml.
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from tpu_slam_torch.cli.common import add_common_args, emit
from tpu_slam_torch.ingest.calibration import (CalibConfig, CalibrationCapture,
                                               CalibrationData,
                                               calibrate_gradient,
                                               calibrate_sa,
                                               calibrate_twiddle,
                                               capture_from_lms,
                                               export_verification,
                                               extrinsic_matrix)


DEMO_TRUE = (0.015, -0.01, 0.01, -0.012, 0.018)


def demo_data(device, n_segments: int = 360, n_beams: int = 181,
              fov_deg: float = 180.0, true=DEMO_TRUE):
    """A synthetic full rotation in the reference test's room whose true
    mount carries the extrinsic ``true``: (CalibrationData, true params5)."""
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.ingest.frames import rotation_link_transform

    true = np.asarray(true, np.float32)
    world = syn.make_room(size=(5.0, 4.0, 2.5), boxes=[
        (np.array([0.8, 0.6, 0.0]), np.array([1.6, 1.3, 1.1])),
        (np.array([-1.8, -1.4, 0.0]), np.array([-1.0, -0.7, 1.7]))])
    M = extrinsic_matrix(torch.from_numpy(true)).numpy()
    T_base = syn.se2_pose(0, 0, 0, z=1.0)
    S, L = n_segments, n_beams
    pts = np.zeros((S, L, 3), np.float32)
    val = np.zeros((S, L), bool)
    angs = torch.from_numpy(np.linspace(0, 2 * math.pi, S, endpoint=False)
                            .astype(np.float32))
    Ts = rotation_link_transform(angs).numpy()
    for s in range(S):
        pts[s], val[s] = syn.simulate_line_scan(
            world, T_base @ Ts[s] @ M, n_beams=L, fov_deg=fov_deg)
    data = CalibrationData(points=torch.from_numpy(pts).to(device),
                           valid=torch.from_numpy(val).to(device),
                           transforms=torch.from_numpy(Ts).to(device))
    return data, true


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", default=None, help="segments .npz")
    p.add_argument("--demo", action="store_true",
                   help="solve a synthetic capture instead of --input")
    p.add_argument("--capture", action="store_true",
                   help="capture segments live from the rotating unit "
                        "(m3d_calibration_twiddle.cpp:56-82,312-317)")
    p.add_argument("--lms-host", default=None)
    p.add_argument("--lms-port", type=int, default=2111)
    p.add_argument("--m3d-host", default=None)
    p.add_argument("--m3d-port", type=int, default=10001)
    p.add_argument("--m3d-serial", default=None)
    p.add_argument("--speed", type=int, default=12)
    p.add_argument("--sweep-pi", type=float, default=2.0,
                   help="required rotation sweep in multiples of pi "
                        "(2 default, 6 for Velodyne)")
    p.add_argument("--save-segments", default=None,
                   help="also write the captured segments .npz")
    p.add_argument("--method", choices=["twiddle", "sa", "gradient"],
                   default="gradient")
    p.add_argument("--out", default=None,
                   help="calibration yaml path (reference format)")
    p.add_argument("--verify-ply", default=None,
                   help="write the aligned half-clouds red/green as a .ply "
                        "(the reference's PCL red/green operator check, "
                        "m3d_calibration_twiddle.cpp:384-424)")
    p.add_argument("--min-matched", type=float, default=0.0,
                   help="refuse to persist --out when the verification "
                        "matched_fraction falls below this (0 disables)")
    p.add_argument("--up-axis", type=int, default=1)
    p.add_argument("--max-evaluations", type=int, default=300)
    add_common_args(p)
    args = p.parse_args(argv)

    from tpu_slam_torch import default_device

    device = default_device(args.device)
    true = None
    if args.capture:
        from tpu_slam_torch.ingest.native import NativeLms, NativeM3d
        if not (args.m3d_serial or args.m3d_host):
            raise SystemExit("--capture needs --m3d-host or --m3d-serial")
        if not args.lms_host:
            raise SystemExit("--capture needs --lms-host")
        m3d = NativeM3d()
        lms = NativeLms(cap=2048)
        cap = CalibrationCapture(sweep_rad=args.sweep_pi * math.pi)
        try:
            if args.m3d_serial:
                m3d.connect_serial(args.m3d_serial)
            else:
                m3d.connect_tcp(args.m3d_host, args.m3d_port)
            m3d.set_speed(args.speed)
            lms.connect(args.lms_host, args.lms_port)
            lms.start_scan()
            capture_from_lms(lms, m3d.angle, cap)
        finally:
            try:
                m3d.set_speed(0)
            except ConnectionError:
                pass
            lms.close()
            m3d.close()
        if not cap.complete:
            raise SystemExit(f"capture incomplete: swept "
                             f"{cap.progress:.1f}% of the required "
                             f"{args.sweep_pi}*pi")
        data = cap.data(device=device)
        if args.save_segments:
            np.savez_compressed(args.save_segments,
                                points=data.points.cpu().numpy(),
                                valid=data.valid.cpu().numpy(),
                                transforms=data.transforms.cpu().numpy())
    elif args.demo:
        data, true = demo_data(device)
    elif args.input:
        with np.load(args.input) as z:
            data = CalibrationData(
                points=torch.from_numpy(z["points"]).to(device),
                valid=torch.from_numpy(z["valid"]).to(device),
                transforms=torch.from_numpy(z["transforms"]).to(device))
    else:
        raise SystemExit("need --input, --demo, or --capture")

    cfg = CalibConfig(up_axis=args.up_axis, half_extent=8.0, capacity=65536)
    if args.method == "twiddle":
        res = calibrate_twiddle(data, cfg,
                                max_evaluations=args.max_evaluations)
    elif args.method == "sa":
        res = calibrate_sa(data, cfg)
    else:
        res = calibrate_gradient(data, cfg, steps=args.max_evaluations)

    summary = {"method": args.method, "cost": res.cost,
               "evaluations": res.evaluations,
               "params5": [float(v) for v in res.params5]}
    if true is not None:
        summary["true_params5"] = [float(v) for v in true]
    verify = export_verification(data, res.params5, cfg,
                                 ply_path=args.verify_ply)
    summary["verification"] = verify
    ok = verify["matched_fraction"] >= args.min_matched
    summary["verification_passed"] = bool(ok)
    if args.out:
        if not ok:
            emit(summary, args.json)
            raise SystemExit(
                f"verification matched_fraction "
                f"{verify['matched_fraction']} < {args.min_matched}; "
                f"refusing to persist {args.out} (inspect the "
                f"--verify-ply artifact)")
        summary["calibration_file"] = res.to_calibration().save(args.out)
    emit(summary, args.json)


if __name__ == "__main__":
    main()
