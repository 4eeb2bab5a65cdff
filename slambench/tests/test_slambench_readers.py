"""The readers of the dense step's stage marks, the program's counters and
its sweep spans: on a synthetic ``Trace`` with planted mark kernels, on a
recorder holding planted spans and counters, and where there is nothing
to read."""

import time

import pytest
import torch

from slambench import plugins
from slambench.trace import Trace
from tpu_slam_torch.utils import tracing

STAGE_READERS = {"prep": "scan_prep_ms_per_scan",
                 "map": "map_update_ms_per_scan",
                 "field": "field_build_ms_per_scan",
                 "raster": "terms_raster_ms_per_scan",
                 "solve": "ndt_solve_ms_per_scan"}
SHARES = {"ndt_iters_used_share": "ndt_lm_iters",
          "cg_iters_used_share": "cg_iters",
          "icp_trips_used_share": "icp_trips"}


def _mark(stage, at):
    return (f"void span_mark<stage_{stage}>(long long*, int)", at,
            at + 1e-6)


def _trace(ops, scans=2, window_s=1.0):
    return Trace(scans=scans, window_s=window_s, device_ops=ops,
                 host_counts={},
                 busy_s=sum(e - s for _, s, e in ops))


def _two_steps():
    """Two steps, 10 ms apart: each stage's kernels (overlapping ones
    counted once), a raster and a solve twice, then the end mark and the
    copies after it."""
    ops = []
    for base in (0.0, 0.010):
        t = base
        for stage, kernels in (("prep", [0.3e-3]),
                               ("map", [0.1e-3, 0.1e-3]),
                               ("field", [0.5e-3]),
                               ("solve", [0.05e-3]),
                               ("raster", [0.2e-3]),
                               ("solve", [0.4e-3]),
                               ("raster", [0.2e-3]),
                               ("solve", [0.4e-3]),
                               ("map", [0.6e-3]),
                               ("end", [0.25e-3])):
            ops.append(_mark(stage, t))
            t += 2e-6
            for k in kernels:
                ops.append(("kernel", t, t + k))
                # a second stream's kernel inside the first one's interval
                ops.append(("overlapping kernel", t, t + 0.5 * k))
                t += k + 1e-6
    return ops


def test_stage_readers_split_the_planted_marks():
    t = _trace(_two_steps())
    want = {"prep": 0.3, "map": 0.8, "field": 0.5, "raster": 0.4,
            "solve": 0.85}
    for stage, name in STAGE_READERS.items():
        got = plugins.load("metrics", name).read(t)
        assert got == pytest.approx(want[stage], rel=1e-9), stage


def test_stage_readers_find_nothing_without_marks():
    for name in STAGE_READERS.values():
        reader = plugins.load("metrics", name)
        assert reader.read(_trace([("kernel", 0.0, 1e-3)])) is None
        assert reader.read(_trace([])) is None
    # a stretch without the field's mark: that stage alone is None
    ops = [op for op in _two_steps() if "stage_field" not in op[0]]
    assert plugins.load("metrics", STAGE_READERS["field"]).read(
        _trace(ops)) is None
    assert plugins.load("metrics", STAGE_READERS["map"]).read(
        _trace(ops)) > 0


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_readers_read_the_recorded_stretch(name):
    reader = plugins.load("metrics", name)
    prefix = SHARES[name]
    # counted before the stretch: not read
    tracing.device_count(f"{prefix}_used", torch.tensor(50))
    with tracing.enable():
        assert reader.read(_trace([])) is None
        tracing.device_count(f"{prefix}_used", torch.tensor(3))
        if name == "ndt_iters_used_share":
            tracing.device_count(f"{prefix}_run", 12, device="cpu")
        else:
            tracing.count(f"{prefix}_run", 12)
        assert reader.read(_trace([])) == pytest.approx(0.25)


@pytest.mark.parametrize("name",
                         sorted(SHARES) + ["sweep_idle_ms_per_sweep"])
def test_program_readers_without_the_recorder(name, monkeypatch):
    """A program whose tracing module has no recorder (the parent's):
    nothing to read, and no raise."""
    monkeypatch.delattr(tracing, "counters")
    monkeypatch.delattr(tracing, "spans")
    reader = plugins.load("metrics", name)
    assert reader.read(_trace([("kernel", 0.0, 1e-3)])) is None


def test_sweep_idle_reads_the_gaps_inside_sweep_spans():
    reader = plugins.load("metrics", "sweep_idle_ms_per_sweep")
    with tracing.enable():
        with tracing.span("slam.step", step=True):
            with tracing.span("sweep"):
                time.sleep(0.004)
        with tracing.span("not a sweep"):
            time.sleep(0.004)
        with tracing.span("sweep"):
            time.sleep(0.004)
    sweeps = [s for s in tracing.spans() if s.name == "sweep"]
    assert len(sweeps) == 2
    (a0, b0), (a1, b1) = ((s.start_ns * 1e-9, s.end_ns * 1e-9)
                          for s in sweeps)
    # busy: 1 ms inside the first sweep (two overlapping kernels), one
    # kernel straddling its end by 1 ms, and 1 ms between the sweeps
    ops = [("k", a0 + 0.5e-3, a0 + 1.5e-3), ("k", a0 + 0.7e-3, a0 + 1.2e-3),
           ("k", b0 - 0.5e-3, b0 + 1e-3), ("k", b0 + 1.1e-3, b0 + 2e-3)]
    want = ((b0 - a0) - 1.5e-3 + (b1 - a1)) / 2
    got = reader.read(_trace(ops))
    # seconds since the epoch as floats: a quarter of a microsecond apart
    assert got == pytest.approx(1e3 * want, abs=1e-3)
    # no device operations (a CPU run): no device idle to read
    assert reader.read(_trace([])) is None
    with tracing.enable():
        pass
    assert reader.read(_trace(ops)) is None
