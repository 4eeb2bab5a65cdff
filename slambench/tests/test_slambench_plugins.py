"""A configuration, a traffic mix and a per-layer metric added as new
files (and manifest entries) only, and the harness runs them: with them a
world, a route shape and a sensor that the harness has never seen, each a
new file of its own."""

import json
import time

import torch

from slambench.run import run_cell
from slambench.tests.tiny_cells import make_root


def test_new_files_only(tmp_path):
    torch.set_num_threads(2)
    root = make_root(tmp_path)
    sb = root / "slambench"
    before = {p: p.read_bytes() for p in sb.rglob("*") if p.is_file()}
    (sb / "worlds" / "dummy_plaza.py").write_text(
        "from slambench import plugins\n"
        "from slambench.world import box\n\n\n"
        "def patches(seed, kiosks):\n"
        "    out = plugins.load('worlds', 'dense_city').patches(seed=seed)\n"
        "    for x, y in kiosks:\n"
        "        out += box((x, y, 0.0), (x + 1.0, y + 1.0, 2.5))\n"
        "    return out\n")
    (sb / "routes" / "dummy_straight.py").write_text(
        "import math\n\nimport numpy as np\n\n"
        "from slambench.world import se2_pose\n\n\n"
        "def poses(n, start, heading, step, z):\n"
        "    c, s = math.cos(heading), math.sin(heading)\n"
        "    return np.stack([se2_pose(start[0] + k * step * c,\n"
        "                              start[1] + k * step * s, heading, z)\n"
        "                     for k in range(n)])\n")
    (sb / "sensors" / "dummy_rings.py").write_text(
        "from slambench.world import ring_scans\n\n\n"
        "def scans(patches, poses, sensor, seed, device):\n"
        "    return ring_scans(patches, poses, sensor, seed, device,\n"
        "                      sensor['elevations_deg'])\n")
    cfg = json.loads((sb / "configs" / "tiny_odometry.json").read_text())
    cfg["world"] = {"kind": "dummy_plaza", "seed": 3,
                    "kiosks": [[-30.0, -10.0], [-18.0, 1.0], [-6.0, -10.0]]}
    cfg["sensor"].update(model="dummy_rings", elevations_deg=[
        -15.0, -11.0, -7.0, -4.0, -2.0, 0.0, 2.0, 4.0, 7.0, 11.0])
    (sb / "configs" / "dummy_city.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "dummy_street.json").write_text(json.dumps({
        "route": {"shape": "dummy_straight", "start": [-40.0, -4.0],
                  "heading": 0.0, "step": 1.2, "z": 1.8},
        "scans": 40, "repeat": False, "setup_scans": 3,
        "profile": {"scans": 2}}))
    (sb / "metrics" / "dummy_traced_scans.py").write_text(
        "def read(t):\n    return float(t.scans)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy_city", "source": "test",
                         "file": "slambench/configs/dummy_city.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "dummy-cell", "config": "dummy_city",
                           "traffic": "dummy_street", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "dummy_traced_scans", "unit": "scans",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "scans_per_s",
                           "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data

    out = run_cell(root, "dummy-cell", 2**31 + 11, 1.0, False, device="cpu",
                   t0=time.perf_counter())
    assert set(out["metrics"]) == {"scans_per_s", "scan_latency_p95_ms",
                                   "setup_s"}
    out = run_cell(root, "dummy-cell", 2**31 + 11, 1.0, True, device="cpu",
                   t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_traced_scans"] == {"value": 2.0,
                                                    "unit": "scans"}
    assert list(out)[-1] == "checks"
    # no device numbers from a CPU run
    assert out["device"]["memory_peak_bytes"] is None
    assert "step_device_ms" not in out["metrics"]
