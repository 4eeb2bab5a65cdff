"""Run one benchmark cell once and print its result line.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``slambench/configs/<config>.json``: the system under
test, its settings, the world and the sensor) and a traffic mix
(``slambench/traffic/<traffic>.json``: the route, how many scans it has,
whether they repeat, how many drive the set-up). The system, the world,
the route and the sensor they name are files of their own
(``slambench/plugins.py``). Set-up casts every scan
of the route on the card, builds the system and drives the set-up scans
through it. The window then hands the scans over one at a time, the next
when the previous pose is on the host (one client, closed loop), for
``--seconds``. With ``--trace 1`` the window is followed by a traced
stretch of whole scans, and the line carries the cell's per-layer metrics
(``slambench/metrics/<name>.py``) in place of its end-to-end ones.

Once the window has closed and the peak memory is read, the program's
state is freed and its outputs are judged against the plain reference in
``slambench/reference`` (the system module's ``check``); each number
compared and its limit from the configuration are printed on standard
error and under ``checks``, the last key of the line. The run fails, and
prints no result, without a CUDA device (or with fewer than the cell
asks for) and when a JAX module or the JAX package is loaded at its end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_slam")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``tpu_slam_torch`` is not ``tpu_slam``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _cell(manifest: Dict, workload: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def _config_file(root: pathlib.Path, manifest: Dict, name: str) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t0: Optional[float] = None, program_tf32: bool = False,
             marks: Optional[Dict[str, float]] = None) -> Dict:
    """One run of ``workload``; returns the result line's object.
    ``program_tf32`` runs the program's matmuls in TF32 (the control of
    ``slambench.control``); the check runs with TF32 off either way.
    ``marks``: seconds from ``t0`` at which the caller's own set-up steps
    ended, kept with the run's (``info.setup_marks_s``)."""
    import numpy as np
    import torch

    from tpu_slam_torch.core.pointcloud import PointCloud

    from slambench import plugins, world

    t0 = T_START if t0 is None else t0
    marks = dict(marks or {}, imports=time.perf_counter() - t0)
    root = pathlib.Path(root)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = _cell(manifest, workload)
    config = _config_file(root, manifest, cell["config"])
    traffic = json.loads((root / "slambench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    seed = int(seed) % (1 << 63)
    system = plugins.load("systems", config["system"], root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def mark(name):
        _sync(dev)
        marks[name] = time.perf_counter() - t0

    # set-up: the scans, the system, the set-up drive and its warm-ups
    torch.zeros(1, device=dev)
    mark("context")
    patches = world.make_world(config["world"], root)
    route = world.make_route(traffic["route"], traffic["scans"], root)
    pts, msk = world.make_scans(patches, route, config["sensor"], seed, dev,
                                root)
    mark("scans")
    torch.backends.cuda.matmul.allow_tf32 = program_tf32
    driver = system.Driver(config, dev)
    mark("system")

    def cloud(i):
        return PointCloud(points=pts[i], mask=msk[i])

    n_scans = traffic["scans"]

    def index(k):
        """The k-th scan handed over; None once a route that does not
        repeat has run out."""
        if k < n_scans:
            return k
        return k % n_scans if traffic["repeat"] else None

    driver.start(cloud(0), 0, route[0])
    for k in range(1, traffic["setup_scans"]):
        driver.step(cloud(k), k)
    mark("setup_scans")
    driver.warm()
    mark("warm")
    setup_s = marks["warm"]

    # the window: one client, the next scan when the last pose is back
    k = traffic["setup_scans"]
    window_from = len(driver.src)
    latencies, attempted, failed = [], 0, 0
    before = driver.counters()
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    while True:
        ts = time.perf_counter()
        if ts >= deadline or index(k) is None:
            break
        pose = driver.step(cloud(index(k)), index(k))
        te = time.perf_counter()
        k += 1
        attempted += 1
        failed += int(not np.all(np.isfinite(pose)))
        if te <= deadline:
            latencies.append(te - ts)
    after = driver.counters()
    # a route that ran out ends the window early: the rate is over the
    # time the scans took
    window_s = min(seconds, time.perf_counter() - t_w0)

    result: Dict = {"correct": False, "attempted": attempted,
                    "failed": failed}
    if trace:
        tr = _traced(driver, cloud, index, k, traffic["profile"])
        tr.stages = {s: after["stages"][s] - before["stages"][s]
                     for s in after.get("stages", {})}
        tr.stage_counts = {c: after[c] - before[c] for c in after
                           if c != "stages"}
        tr.stage_counts["scans"] = len(latencies)
        metrics = {}
        for m in manifest["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            reader = plugins.load("metrics", m["name"], root)
            value = reader.read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": [[n, s] for n, s in tr.gaps]}
        busy, traced_s = tr.busy_s, tr.window_s
    else:
        values = {
            "scans_per_s": len(latencies) / window_s,
            "scan_latency_p95_ms": (1e3 * float(np.percentile(latencies, 95))
                                    if latencies else float("inf")),
            "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in manifest["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    result["device"] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"].update(busy_s=busy, window_s=traced_s)

    # the check, once the program's state is freed
    record = driver.release()
    del driver
    # the route's pose at each step's scan: the accuracies on the info line
    record["truth"] = route[np.asarray(record["src"])]
    torch.backends.cuda.matmul.allow_tf32 = False
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = system.check(config, pts, msk, record, window_from, seed, dev)
    limits = config["check"]["limits"]
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    result["correct"] = bool(failed == 0 and all(
        v <= limits[n] for n, v in numbers.items()))
    info = dict(record.get("info", {}), scans_in_window=len(latencies),
                latency_p50_ms=(1e3 * statistics.median(latencies)
                                if latencies else None),
                setup_marks_s=marks, check_s=time.perf_counter() - t_check)
    gt = record["truth"][window_from:]
    est = record["poses"][window_from:]
    if len(est):
        d = est[:, :3, 3] - gt[:, :3, 3]
        info["window_ate_m"] = float(np.sqrt(np.mean(np.sum(d * d, 1))))
    result["info"] = info
    result["checks"] = checks
    return result


def _traced(driver, cloud, index, k: int, profile: Dict):
    """The traced stretch after the window: whole scans from the k-th, at
    least ``profile['scans']`` of them and, where the profile asks, until
    ``min_sweeps`` loop sweeps have run; its counters are the driver's
    over the stretch."""
    from slambench.trace import profiled

    c0 = driver.counters()

    def stretch():
        n = 0
        while n < profile["scans"] or (
                driver.counters().get("sweeps", 0) - c0.get("sweeps", 0)
                < profile.get("min_sweeps", 0)):
            i = index(k + n)
            if i is None:
                break
            driver.step(cloud(i), i)
            n += 1
        return n

    tr = profiled(stretch)
    c1 = driver.counters()
    tr.counts = {c: c1[c] - c0[c] for c in c1 if c != "stages"}
    return tr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = pathlib.Path.cwd()
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    chips = _cell(manifest, args.workload)["chips"]
    cache = root / ".slambench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    marks = {"torch_import": time.perf_counter() - T_START}
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks["cuda_driver"] = time.perf_counter() - T_START
    if found < chips:
        print(f"slambench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": result.pop("info")}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
