"""The controls of the comparison that decides ``correct``.

Each has to come out not correct; none runs in a benchmark run.

* ``reference``: the plain reference put in the program's place and run in
  TF32, the precision below the configuration's float32 with TF32 off
  (``dense_odometry`` systems). It drives the cell's own scans from the
  start of the route through ``--scans`` steps on its own registrations;
  the check then judges those poses exactly as it judges the program's,
  at the cell's own sample size, with the window taken to start where
  the cell's window starts.
* ``program``: the cell's own run with TF32 switched on for the program's
  matmuls (every system); TF32 is off again before the check.
* ``graph``: the cell's own run with the reference's pose-graph solve in
  the program's place, reading its inputs in bfloat16 (``slam`` systems).

    python3 -m slambench.control --workload <cell> --mode reference \
        --seeds 1 2 3 --scans 48
    python3 -m slambench.control --workload <cell> --mode program \
        --seeds 1 2 3 --seconds 10

Each seed prints one JSON line: the numbers compared, their limits and
whether the run would count as correct.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Dict

import numpy as np
import torch


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference_in_place(root: pathlib.Path, workload: str, seed: int,
                       n_scans: int, device: str = "cuda") -> Dict:
    from slambench import plugins, run, world
    from slambench.reference.odometry import DenseOdometryReference
    from slambench.reference.pointcloud import PointCloud

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = run._cell(manifest, workload)
    config = run._config_file(root, manifest, cell["config"])
    traffic = json.loads((root / "slambench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    if config["system"] != "dense_odometry":
        raise SystemExit("the reference control drives dense_odometry cells")
    seed = int(seed) % (1 << 63)
    dev = torch.device(device)
    route = world.make_route(traffic["route"], traffic["scans"], root)
    pts, msk = world.make_scans(world.make_world(config["world"], root),
                                route, config["sensor"], seed, dev, root)
    src = [k % traffic["scans"] for k in range(n_scans)]
    ref = DenseOdometryReference(config["odometry"], dev)
    t0 = time.perf_counter()
    _tf32(True)
    try:
        ref.start(PointCloud(points=pts[0], mask=msk[0]),
                  torch.as_tensor(route[0], device=dev))
        poses = [ref.pose.cpu().numpy()]
        acc, ins = [True], [True]
        for i in src[1:]:
            r = ref.forward(PointCloud(points=pts[i], mask=msk[i]))
            poses.append(r.T.cpu().numpy())
            acc.append(r.accepted)
            ins.append(r.inserted)
    finally:
        _tf32(False)
    forward_s = time.perf_counter() - t0
    del ref
    record = dict(src=src, poses=np.stack(poses), accepted=np.asarray(acc),
                  inserted=np.asarray(ins))
    limits = config["check"]["limits"]
    numbers = plugins.load("systems", "dense_odometry", root).check(
        config, pts, msk, record, traffic["setup_scans"], seed, dev)
    return dict(mode="reference", seed=seed, scans=n_scans,
                forward_s=forward_s, info=record.get("info"), correct=all(
                    v <= limits[n] for n, v in numbers.items()),
                checks={n: {"value": v, "limit": limits[n]}
                        for n, v in numbers.items()})


def program_in_tf32(root: pathlib.Path, workload: str, seed: int,
                    seconds: float, device: str = "cuda") -> Dict:
    from slambench import run

    out = run.run_cell(root, workload, seed, seconds, False, device,
                       t0=time.perf_counter(), program_tf32=True)
    return dict(mode="program", seed=seed, correct=out["correct"],
                info=out["info"], checks=out["checks"])


def graph_in_bf16(root: pathlib.Path, workload: str, seed: int,
                  seconds: float, device: str = "cuda") -> Dict:
    """The cell's run with the reference's graph solve in the program's
    place, its inputs (node poses, edge transforms and information) in
    bfloat16: the solve is float32 element-wise work, which TF32 does not
    reach, and its batched inverses and solves have no bfloat16 form, so
    the precision below is put on what it reads."""
    import dataclasses

    from slambench import run
    from slambench.reference.pose_graph import (GraphSolveParams, PoseGraph,
                                                optimize_pose_graph)
    from tpu_slam_torch.pipeline import slam as slam_mod

    def bf16(t):
        return (t.to(torch.bfloat16).to(t.dtype)
                if t.is_floating_point() else t)

    def stand_in(graph, params, compiled=True):
        g = PoseGraph(**{f.name: bf16(getattr(graph, f.name))
                         if f.name != "n_nodes" else graph.n_nodes
                         for f in dataclasses.fields(PoseGraph)})
        out, chi2 = optimize_pose_graph(
            g, GraphSolveParams(**dataclasses.asdict(params)))
        return dataclasses.replace(graph, poses=out.poses), chi2

    real = slam_mod.optimize_pose_graph
    slam_mod.optimize_pose_graph = stand_in
    try:
        out = run.run_cell(root, workload, seed, seconds, False, device,
                           t0=time.perf_counter())
    finally:
        slam_mod.optimize_pose_graph = real
    return dict(mode="graph", seed=seed, correct=out["correct"],
                info=out["info"], checks=out["checks"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("reference", "program", "graph"),
                   required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--scans", type=int, default=48)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    root = pathlib.Path.cwd()
    if not torch.cuda.is_available():
        print("slambench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        if args.mode == "reference":
            out = reference_in_place(root, args.workload, seed, args.scans)
        elif args.mode == "program":
            out = program_in_tf32(root, args.workload, seed, args.seconds)
        else:
            out = graph_in_bf16(root, args.workload, seed, args.seconds)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
