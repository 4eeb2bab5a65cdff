"""A tiny copy of the ``host-slam-survey`` cell for the CPU tests.

``make_root(tmp)`` is ``tiny_cells.make_root`` with one more cell,
``tiny-survey``: the survey's configuration and traffic cut to a size a
CPU test can hold (a smaller ring corridor and its route, 181 beams at
1.5 degrees and 24 lines a stop, smaller keyframe, map and aggregator
capacities, a loop gap of 10 keyframes and a sweep every 2), in files of
its own with its own manifest entries; no existing file is edited.
"""

from __future__ import annotations

import json
import pathlib

from slambench.tests import tiny_cells


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    root = tiny_cells.make_root(tmp)
    cfg = root / "slambench" / "configs"
    trf = root / "slambench" / "traffic"
    c = json.loads((cfg / "m3d_survey_host.json").read_text())
    c["live"].update(line_capacity=256)
    c["live"]["aggregator"].update(capacity=8192, line_length=256)
    s = c["slam"]
    s.update(keyframe_capacity=96, keyframe_cloud_capacity=512,
             loop_every=2, edge_capacity=256)
    s["loop"].update(min_index_gap=10, max_candidates=4)
    s["odometry"].update(scan_capacity=2048, map_capacity=16384,
                         map_half_extent=16.0)
    c["sensor"].update(beams=181, step_deg=1.5, lines=24)
    c["world"] = {"kind": "ring_corridor", "outer": [12.0, 10.0, 3.0],
                  "inner": [5.0, 3.0]}
    c["check"].update(sample_scans=3, sample_sweeps=2)
    (cfg / "tiny_survey.json").write_text(json.dumps(c))
    t = json.loads((trf / "corridor_survey.json").read_text())
    t["route"].update(half=[4.0, 3.0], corner_radius=1.0)
    t.update(scans=110, setup_scans=58, profile={"scans": 2})
    (trf / "tiny_survey.json").write_text(json.dumps(t))

    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_survey", "source": "test",
                         "file": "slambench/configs/tiny_survey.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny-survey", "config": "tiny_survey",
                           "traffic": "tiny_survey", "chips": 1,
                           "why": "test"})
    for p in m["end_to_end"] + m["per_layer"]:
        if "host-slam-survey" in p.get("workloads", []):
            p["workloads"].append("tiny-survey")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root
