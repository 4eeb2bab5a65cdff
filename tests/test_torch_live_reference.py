"""The reference number of ``chip_smoke.py``'s live phase.

Run as a script, this feeds ``chip_smoke.survey()``'s line stream (the
base stopping at 32 poses of a 2.5 m circle in the office, 150 lines of
541 beams a 3D scan, 4,800 lines) through tpu_slam's ScanAggregator and
SLAMSystem (the reference) on the CPU, with no threads: each telegram
parsed by the native parser (the arrays NativeLms hands the pipeline),
each line expanded and transformed as ``tpu_slam.pipeline.live`` does it,
``chip_smoke.survey_slam_config()``'s settings on the reference's kernel
path, its Pallas pass replaced by ``compact_raster_reference`` (as
``test_torch_host_reference`` does). With ``--port`` it runs the port's
ScanAggregator and SLAMSystem on the same lines on the CPU too. One JSON
line per engine: points a scan, keyframes, loops, the ATE against the
route, seconds::

    python -m tests.test_torch_live_reference [--port]

As a test it holds the pieces the script stands on: the reference's
configuration equals the port's survey configuration field for field, and
on the survey's first 300 lines (fewer beams) both packages' aggregators
emit on the lines the generator put the stops on.
"""

import dataclasses
import json
import math
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs

L = 1024            # LiveConfig().line_capacity


def _reference_slam_config():
    """survey_slam_config() as the reference's, on its kernel path."""
    from tpu_slam.pipeline.config import SLAMConfig

    base = SLAMConfig()
    odo = dataclasses.replace(base.odometry, ndt=dataclasses.replace(
        base.odometry.ndt, terms_impl="pallas_interpret"))
    return dataclasses.replace(base, odometry=odo, loop=dataclasses.replace(
        base.loop, min_index_gap=cs.SURVEY_LOOP_GAP))


def _lines(telegrams):
    """(ranges, beam directions) of each telegram, parsed natively."""
    from tpu_slam_torch.ingest.native import parse_telegram_native

    out = []
    dirs = None
    for raw in telegrams:
        meta, ranges, _ = parse_telegram_native(raw[1:-1])
        if dirs is None:
            ang = (math.radians(cs.LIVE_START_DEG)
                   + math.radians(meta.ang_step_deg)
                   * np.arange(ranges.shape[0]))
            dirs = np.stack([np.cos(ang), np.sin(ang),
                             np.zeros(ranges.shape[0])],
                            axis=1).astype(np.float32)
        out.append(ranges)
    return out, dirs


def _padded(ranges, dirs, range_min=0.01, range_max=100.0):
    """LivePipeline.run's line arrays (LiveConfig()'s range gate)."""
    n = ranges.shape[0]
    pts_p = np.zeros((L, 3), np.float32)
    val_p = np.zeros((L,), bool)
    pts_p[:n] = dirs * ranges[:, None]
    val_p[:n] = (ranges >= range_min) & (ranges <= range_max)
    return pts_p, val_p, np.zeros((L,), np.float32)


def run_reference(telegrams, angles, slam=True):
    """(clouds' point counts, poses, slam state or None, line index of
    each emit) of tpu_slam's chain on the lines."""
    from tpu_slam.ingest.aggregator import AggregatorConfig, ScanAggregator
    from tpu_slam.ingest.frames import FrameChain, SensorModel
    from tpu_slam.pipeline.slam import SLAMSystem

    ranges, dirs = _lines(telegrams)
    agg = ScanAggregator(AggregatorConfig(line_length=L))
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    system = SLAMSystem(_reference_slam_config()) if slam else None
    state = system.init_state() if slam else None
    a = agg.init_state()
    counts, poses, emits = [], [], []
    for k, (r, ang) in enumerate(zip(ranges, angles)):
        p, v, i = _padded(r, dirs)
        a = agg.add_line(a, jnp.asarray(p), jnp.asarray(v),
                         chain.base_from_laser(jnp.float32(ang)),
                         jnp.asarray(i))
        if bool(agg.ready(a)):
            cloud, a = agg.emit(a)
            emits.append(k)
            counts.append(int(np.sum(np.asarray(cloud.mask))))
            if slam:
                state, _ = system.step(state, cloud)
                poses.append(np.asarray(state.odom.pose))
    return counts, poses, state, emits


def run_port(telegrams, angles, slam=True):
    """The same through the port's ScanAggregator and SLAMSystem on the
    CPU (LivePipeline.run's per-line arithmetic, no threads)."""
    from tpu_slam_torch.ingest.aggregator import (AggregatorConfig,
                                                  ScanAggregator)
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    ranges, dirs = _lines(telegrams)
    agg = ScanAggregator(AggregatorConfig(line_length=L), device="cpu")
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    system = SLAMSystem(cs.survey_slam_config(), device="cpu") if slam \
        else None
    state = system.init_state() if slam else None
    a = agg.init_state()
    counts, poses, emits = [], [], []
    for k, (r, ang) in enumerate(zip(ranges, angles)):
        p, v, i = _padded(r, dirs)
        a = agg.add_line(a, torch.from_numpy(p), torch.from_numpy(v),
                         chain.base_from_laser(float(ang)),
                         torch.from_numpy(i))
        if bool(agg.ready(a)):
            cloud, a = agg.emit(a)
            emits.append(k)
            counts.append(int(cloud.mask.sum()))
            if slam:
                state, _ = system.step(state, cloud)
                poses.append(state.odom.pose.numpy())
    return counts, poses, state, emits


def test_reference_config_is_the_survey_config():
    ref = dataclasses.asdict(_reference_slam_config())
    got = dataclasses.asdict(cs.survey_slam_config())
    assert ref["odometry"]["ndt"].pop("terms_impl") == "pallas_interpret"
    assert got["odometry"]["ndt"].pop("terms_impl") == "auto"
    # fields the port leaves out by rule: the TPU gather-cost tiers
    for name in set(ref["odometry"]["ndt"]) - set(got["odometry"]["ndt"]):
        ref["odometry"]["ndt"].pop(name)
    assert ref == got


def test_both_aggregators_emit_where_the_survey_moves_the_base():
    """The survey's stops follow the aggregator's trigger: on its first two
    captures (121 beams a line) both packages emit on the last line of
    each stop, with the same point counts."""
    tg, angles, stops, _ = cs.survey(n_stops=2, beams=121)
    last = [int(np.nonzero(stops == s)[0][-1]) for s in range(2)]
    ref = run_reference(tg, angles, slam=False)
    port = run_port(tg, angles, slam=False)
    assert ref[3] == port[3] == last
    assert ref[0] == port[0] and min(ref[0]) > 5000


def main(argv):
    from tpu_slam.kernels import ndt_terms as j_terms
    from tpu_slam.pipeline.metrics import ate_rmse

    from tests.test_torch_host_reference import compact_raster_reference

    j_terms.ndt_terms_raster = compact_raster_reference
    t0 = time.perf_counter()
    tg, angles, stops, route = cs.survey()
    print(json.dumps(dict(lines=len(tg), stops=int(stops[-1]) + 1,
                          seconds=time.perf_counter() - t0)), flush=True)
    engines = [("tpu_slam ScanAggregator + SLAMSystem, CPU", run_reference)]
    if "--port" in argv:
        engines.append(("tpu_slam_torch ScanAggregator + SLAMSystem, CPU",
                        run_port))
    for name, run in engines:
        t0 = time.perf_counter()
        counts, poses, state, emits = run(tg, angles)
        gt = cs.relative_route(route, len(poses))
        print(json.dumps(dict(
            engine=name, scans=len(poses), points=counts, emit_lines=emits,
            keyframes=int(state.n_keyframes),
            loops=int(state.n_loop_closures),
            ate_m=ate_rmse(np.stack(poses), gt, align=False),
            seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
