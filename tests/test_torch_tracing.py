"""The port's span and counter recorder (``tpu_slam_torch.utils.tracing``)
on the CPU: spans and their ids, recording only while enabled or under
the profiler, the spans on the profiler's clock, counter deltas over the
recorded stretch, the dense step's stage spans and LM counts, the CG and
ICP counts, and the SLAM stage timers with recording on and off. No JAX;
the mark kernels themselves are held in ``test_torch_cuda.py``."""

import contextlib
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.graph import pose_graph as pg
from tpu_slam_torch.graph.loop_closure import LoopClosureParams
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
from tpu_slam_torch.pipeline.slam import SLAMSystem
from tpu_slam_torch.registration import ndt
from tpu_slam_torch.registration.icp import ICPParams, icp
from tpu_slam_torch.utils import tracing


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_and_step_ids():
    with tracing.enable():
        with tracing.span("outside"):
            pass
        for _ in range(2):
            with tracing.span("step", step=True):
                with tracing.span("stage"):
                    # a step inside a step is the outer one's
                    with tracing.span("inner", step=True):
                        pass
        spans = _by_name(tracing.spans())
    assert spans["outside"][0].parent is None
    assert spans["outside"][0].step is None
    steps = spans["step"]
    assert [s.step for s in steps] == [s.id for s in steps]
    assert steps[0].id != steps[1].id
    for st, stage, inner in zip(steps, spans["stage"], spans["inner"]):
        assert stage.parent == st.id and stage.step == st.id
        assert inner.parent == stage.id and inner.step == st.id
        assert st.start_ns <= stage.start_ns <= inner.start_ns
        assert inner.end_ns <= stage.end_ns <= st.end_ns


def test_nothing_is_recorded_while_recording_is_off():
    with tracing.enable():
        pass
    kept = tracing.spans()
    assert not tracing.recording()
    with tracing.span("off") as s:
        assert s.open is None
    tracing.count("off", 3)
    with tracing.stage_marks("cpu"):
        tracing.mark("prep")
    assert tracing.spans() == kept == []
    assert "off" not in tracing.counters()


def test_recording_starts_under_an_active_profiler():
    with tracing.enable():
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        with tracing.span("profiled"):
            tracing.count("profiled", 2)
    assert not tracing.recording()
    # what the stretch recorded stays for its readers
    assert [s.name for s in tracing.spans()] == ["profiled"]
    assert tracing.counters()["profiled"] == 2


def test_span_and_its_profiler_twin_agree():
    """The spans' clock is the profiler's: each span against its
    ``record_function`` range in the CPU profiler's kineto events."""
    names = [f"twin{k}" for k in range(9)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("warm"):
            pass
        for n in names:
            with tracing.span(n):
                torch.ones(64).sum()
    ours = {s.name: s for s in tracing.spans()}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ours}
    starts, ends = [], []
    for n in names:
        e = theirs[n]
        starts.append(abs(e.start_ns() - ours[n].start_ns))
        ends.append(abs(e.start_ns() + e.duration_ns() - ours[n].end_ns))
    # a span's ends bracket its twin's by the profiler's own entry and
    # exit cost; the median keeps a preempted worker out
    assert statistics.median(starts) <= 50_000, starts
    assert statistics.median(ends) <= 50_000, ends


def test_counter_deltas_cover_only_the_recorded_stretch():
    tracing.device_count("test_counter", torch.tensor(5))
    tracing.count("test_host", 7)
    with tracing.enable():
        tracing.device_count("test_counter", torch.tensor(3))
        tracing.device_count("test_counter", 2, device="cpu")
        tracing.count("test_host", 4)
        got = tracing.counters()
    assert got["test_counter"] == 5 and got["test_host"] == 4
    with tracing.enable():
        assert tracing.counters().get("test_counter", 0) == 0


def _clouds(n, n_azimuth=60, capacity=1024):
    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(n):
        T = syn.se2_pose(0.3 * k - 0.6, 0.12 * k - 0.3, 0.07 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=capacity,
                                                  device="cpu"))
        gt.append(T)
    return clouds, np.stack(gt).astype(np.float32)


def _odometry_config():
    return OdometryConfig(
        scan_capacity=512, downsample_leaf=0.25, map_leaf=0.5,
        map_half_extent=16.0, scan_max_range=12.0, insert_downsampled=True,
        ndt=ndt.NDTParams(max_iterations=4, coarse_iterations=1,
                          tolerance=3e-4, min_voxel_count=3.0,
                          window_dims=(12, 12, 8)),
        pyramid_factor=1, rebase_fraction=0.05)


def test_lm_trips_counts_the_sync_free_schedule(monkeypatch):
    """``lm_trips`` against the LM trips (one solve each) that the
    sync-free kernel-path schedule runs."""
    solves = []
    real = torch.linalg.solve_ex

    def counted(*a, **k):
        solves.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.linalg, "solve_ex", counted)
    eye = torch.eye(6)

    def raw_terms(T, gamma, ctx):
        return eye, torch.zeros(6), torch.ones(()), torch.ones(())

    for params in (ndt.NDTParams(max_iterations=10, coarse_iterations=2,
                                 rebin_iters=4),
                   ndt.NDTParams(max_iterations=6, coarse_iterations=0,
                                 rebin_iters=1),
                   ndt.NDTParams(max_iterations=7, coarse_iterations=3,
                                 rebin_iters=3)):
        solves.clear()
        ndt.lm_schedule(torch.eye(4), params, True, raw_terms,
                        lambda T: None, None, sync_free=True)
        assert len(solves) == ndt.lm_trips(params)


def test_dense_step_marks_stages_and_counts_lm_iterations():
    clouds, gt = _clouds(3)
    counts = {}
    for compiled in (True, False):
        eng = DenseLidarOdometry(_odometry_config(), device="cpu",
                                 compiled=compiled)
        state = eng.init_state(clouds[0], gt[0])
        with tracing.enable():
            for c in clouds[1:]:
                state = eng.step(state, c)
            counts[compiled] = tracing.counters()
            spans = tracing.spans()
        steps = [s for s in spans if s.name == "odometry.step"]
        assert len(steps) == 2
        for st in steps:
            stages = [s for s in spans if s.parent == st.id]
            assert {s.name for s in stages} == {
                "dense.prep", "dense.map", "dense.field", "dense.raster",
                "dense.solve"}
            assert all(s.step == st.id for s in stages)
            # flat: one stage after another, in the step's order
            assert all(a.end_ns <= b.start_ns
                       for a, b in zip(stages, stages[1:]))
            assert stages[0].name == "dense.prep"
            assert stages[-1].name == "dense.map"
    trips = 2 * ndt.lm_trips(eng.config.ndt)
    sync_free, host_exit = counts[True], counts[False]
    assert sync_free["ndt_lm_iters_run"] == trips
    assert 0 < sync_free["ndt_lm_iters_used"] <= trips
    # the host-exit form runs only the trips that do work: the same ones
    assert (host_exit["ndt_lm_iters_used"] == host_exit["ndt_lm_iters_run"]
            == sync_free["ndt_lm_iters_used"])


def test_batched_icp_counts_trips():
    rng = np.random.default_rng(3)
    tgt = torch.from_numpy(rng.uniform(-2, 2, (2, 96, 3)).astype(np.float32))
    T = se3.exp(torch.tensor([0.05, -0.02, 0.01, 0.0, 0.0, 0.03]))
    src = se3.apply(se3.inverse(T), tgt)
    mask = torch.ones(2, 96, dtype=torch.bool)
    params = ICPParams(max_iterations=12)
    got = {}
    for compiled in (True, False):
        with tracing.enable():
            res = icp(PointCloud(src, mask), PointCloud(tgt, mask),
                      params=params, compiled=compiled)
            got[compiled] = tracing.counters()
        assert got[compiled]["icp_trips_used"] == int(res.iterations.sum())
    assert got[True]["icp_trips_run"] == 2 * 12
    assert got[False]["icp_trips_run"] == 2 * int(res.iterations.max())
    assert got[True]["icp_trips_used"] == got[False]["icp_trips_used"] < 24


def _slam(min_index_gap):
    cfg = SLAMConfig(
        odometry=_odometry_config(), odometry_engine="dense",
        keyframe_translation=0.0, keyframe_capacity=8,
        keyframe_cloud_capacity=128, edge_capacity=32, loop_every=3,
        loop=LoopClosureParams(min_index_gap=min_index_gap, max_distance=5.0,
                               use_scan_context=False,
                               icp=ICPParams(max_iterations=8,
                                             max_corr_dist=1.0,
                                             huber_delta=0.3)),
        graph=pg.GraphSolveParams(gn_iterations=2, cg_iterations=20))
    return SLAMSystem(cfg, device="cpu")


def test_stage_timers_keep_their_stages_with_recording_on_and_off():
    clouds, gt = _clouds(3)
    seconds, spans = [], None
    for on in (False, True):
        slam = _slam(min_index_gap=1)
        state = slam.init_state(gt[0])
        with tracing.enable() if on else contextlib.nullcontext():
            for c in clouds:
                state, _ = slam.step(state, c)
            if on:
                spans = _by_name(tracing.spans())
                counts = tracing.counters()
        seconds.append((slam.stage_seconds, slam.sweep_seconds))
    (stage_off, sweep_off), (stage_on, sweep_on) = seconds
    assert list(stage_off) == list(stage_on)
    assert list(sweep_off) == list(sweep_on)
    assert ([k for k, v in stage_off.items() if v > 0]
            == [k for k, v in stage_on.items() if v > 0])
    assert ([k for k, v in sweep_off.items() if v > 0]
            == [k for k, v in sweep_on.items() if v > 0])
    # each stage timer was one span, under its scan's step
    assert len(spans["slam.step"]) == 3
    assert len(spans["stage.odometry"]) == 3
    assert len(spans["stage.keyframe"]) == 3
    (sweep,) = spans["sweep"]
    assert len(spans["sweep.candidates"]) == 1
    steps = {s.id for s in spans["slam.step"]}
    for name, group in spans.items():
        if name != "slam.step":
            assert all(s.step in steps for s in group), name
    assert all(sweep.start_ns <= s.start_ns and s.end_ns <= sweep.end_ns
               for s in spans["sweep.verify"])
    # the sweep verified pairs with the batched ICP both ways
    assert 0 < counts["icp_trips_used"] <= counts["icp_trips_run"]
    if stage_on["graph"] > 0:
        assert 0 < counts["cg_iters_used"] <= counts["cg_iters_run"]


def test_pcg_counts_the_cg_iterations_that_did_work():
    g = pg.empty_graph(8, 16, device="cpu")
    rng = np.random.default_rng(5)
    for k in range(6):
        g, _ = pg.add_node(g, se3.exp(torch.tensor(
            [0.5 * k, 0.1, 0.0, 0.0, 0.0, 0.05 * k])))
    for k in range(5):
        Z = se3.exp(torch.tensor([0.5, 0.0, 0.0, 0.0, 0.0, 0.05])
                    + torch.from_numpy(rng.normal(0, 0.02, 6)).float())
        g = pg.add_edge(g, k, k + 1, Z, 100.0 * torch.eye(6))
    g = pg.add_edge(g, 0, 5, se3.exp(torch.tensor(
        [2.4, 0.1, 0.0, 0.0, 0.0, 0.26])), 25.0 * torch.eye(6))
    params = pg.GraphSolveParams(gn_iterations=3, cg_iterations=40,
                                 cg_tolerance=1e-6)
    with tracing.enable():
        pg.optimize_pose_graph(g, params)
        got = tracing.counters()
    # whole chunks of 16, 16 and 8 until the host's flag read stops
    assert got["cg_iters_run"] % 8 == 0 and got["cg_iters_run"] <= 3 * 40
    assert 0 < got["cg_iters_used"] < got["cg_iters_run"]
