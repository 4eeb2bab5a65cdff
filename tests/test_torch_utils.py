"""The port's utilities (tpu_slam_torch.utils.logging, .tracing) against
tests/test_utils.py's bars for tpu_slam.utils, on the CPU."""

import json
import logging

import torch

from tpu_slam.utils.logging import JsonFormatter as JJsonFormatter
from tpu_slam_torch.utils import get_logger, profile_trace, time_jitted
from tpu_slam_torch.utils.logging import JsonFormatter, log_fields
from tpu_slam_torch.utils.tracing import block_until_ready


def test_time_jitted_measures():
    x = torch.ones((64, 64))
    stats = time_jitted(lambda a: (a @ a.T).sum(), x, reps=5, warmup=1)
    assert stats["mean_ms"] > 0 and stats["reps"] == 5
    assert stats["min_ms"] <= stats["p50_ms"] <= stats["mean_ms"] * 5


def test_block_until_ready_walks_results():
    out = dict(a=[torch.zeros(1), (torch.ones(2), 3)], b=None)
    assert block_until_ready(out) is out


def test_json_logging_matches_reference_record(capsys):
    logger = get_logger("tpu_slam_torch.test_json", level="DEBUG",
                        json_lines=True)
    log_fields(logger, logging.INFO, "scan done", scan_index=3, ate=0.01)
    err = capsys.readouterr().err.strip().splitlines()[-1]
    rec = json.loads(err)
    assert rec["msg"] == "scan done"
    assert rec["scan_index"] == 3
    assert rec["level"] == "INFO"
    # the same record through both formatters: the same keys and values
    # (but the time stamp)
    r = logging.LogRecord("x", logging.WARNING, __file__, 1, "m %d", (2,),
                          None)
    r.fields = dict(k=1)
    a, b = (json.loads(f.format(r)) for f in (JsonFormatter(),
                                              JJsonFormatter()))
    a.pop("ts"), b.pop("ts")
    assert a == b


def test_logger_reads_the_environment(monkeypatch, capsys):
    monkeypatch.setenv("TPU_SLAM_LOG_LEVEL", "WARNING")
    monkeypatch.setenv("TPU_SLAM_LOG_JSON", "1")
    logger = get_logger("tpu_slam_torch.test_env")
    assert logger.level == logging.WARNING
    logger.info("dropped")
    logger.warning("kept")
    lines = capsys.readouterr().err.strip().splitlines()
    assert json.loads(lines[-1])["msg"] == "kept"
    assert get_logger("tpu_slam_torch.test_env") is logger   # configured once


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        y = (torch.arange(1000.0) ** 2).sum()
    assert float(y) > 0
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_profile_trace_runs_the_region_when_a_trace_is_active(tmp_path):
    """A second trace cannot start inside the first: the region still runs
    untraced (the reference's behaviour), and the outer trace is written."""
    inner = tmp_path / "inner"
    ran = []
    with profile_trace(str(tmp_path)) as outer:
        with profile_trace(str(inner)) as prof:
            ran.append(prof)
    assert outer is not None and ran == [None]
    assert list(tmp_path.glob("trace-*.json"))
    assert not inner.exists()
