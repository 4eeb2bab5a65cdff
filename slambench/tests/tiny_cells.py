"""Tiny copies of the benchmark's cells for the CPU tests.

``make_root(tmp)`` copies ``BENCHMARK.json`` and the cells' files under
``slambench/`` (configurations, traffic and every part folder) into
``tmp`` and adds two cells of the same kinds at sizes
a CPU test can hold, ``tiny-odometry`` and ``tiny-slam`` (their own
configuration and traffic files and manifest entries; no existing file is
edited). ``run_cell`` on that root with ``device="cpu"`` runs the port's
CPU path and the reference at those sizes.
"""

from __future__ import annotations

import json
import pathlib
import shutil

from slambench.plugins import FOLDERS

REPO = pathlib.Path(__file__).resolve().parents[2]


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    root = pathlib.Path(tmp) / "checkout"
    (root / "slambench").mkdir(parents=True)
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copy(REPO / "BENCHMARK.json", root)
    for d in ("configs", "traffic") + FOLDERS:
        shutil.copytree(REPO / "slambench" / d, root / "slambench" / d,
                        ignore=ignore)
    cfg = root / "slambench" / "configs"
    trf = root / "slambench" / "traffic"

    c2 = json.loads((cfg / "c2_city_dense.json").read_text())
    c2["odometry"]["ndt"]["window_dims"] = [32, 32, 16]
    c2["odometry"]["scan_capacity"] = 2048
    c2["sensor"].update(n_azimuth=128, capacity=2048)
    c2["check"]["sample_scans"] = 3
    (cfg / "tiny_odometry.json").write_text(json.dumps(c2))
    t2 = json.loads((trf / "city_laps.json").read_text())
    t2["setup_scans"] = 3
    (trf / "tiny_laps.json").write_text(json.dumps(t2))

    c4 = json.loads((cfg / "c4_corridor_slam.json").read_text())
    s = c4["slam"]
    s.update(keyframe_capacity=96, keyframe_cloud_capacity=512,
             loop_every=2, edge_capacity=256)
    s["loop"]["min_index_gap"] = 10
    s["odometry"]["scan_capacity"] = 2048
    c4["sensor"].update(n_azimuth=240, capacity=4096)
    c4["world"] = {"kind": "ring_corridor", "outer": [12.0, 10.0, 3.0],
                   "inner": [5.0, 3.0]}
    c4["check"].update(sample_scans=3, sample_sweeps=2)
    (cfg / "tiny_slam.json").write_text(json.dumps(c4))
    t4 = json.loads((trf / "corridor_patrol.json").read_text())
    t4["route"].update(half=[4.0, 3.0], corner_radius=1.0)
    t4.update(scans=120, setup_scans=48, profile={"scans": 2})
    (trf / "tiny_patrol.json").write_text(json.dumps(t4))

    m = json.loads((root / "BENCHMARK.json").read_text())
    for name, cfg_name, traffic, like in (
            ("tiny-odometry", "tiny_odometry", "tiny_laps", "c2-city-laps"),
            ("tiny-slam", "tiny_slam", "tiny_patrol", "c4-corridor-patrol")):
        m["configs"].append({"name": cfg_name, "source": "test",
                             "file": f"slambench/configs/{cfg_name}.json",
                             "reduced": [], "why": "test"})
        m["workloads"].append({"name": name, "config": cfg_name,
                               "traffic": traffic, "chips": 1, "why": "test"})
        for p in m["end_to_end"] + m["per_layer"]:
            if like in p.get("workloads", []):
                p["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root
