"""Structured logging — the ROS_INFO/DEBUG replacement.

Port of ``tpu_slam.utils.logging`` (standard library only): a std-logging
setup with an optional JSON-lines mode so per-scan records interleave
cleanly with the metrics stream in production log pipelines. The
environment variables keep the reference's names.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": time.time(),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def get_logger(name: str = "tpu_slam_torch",
               level: Optional[str] = None,
               json_lines: Optional[bool] = None) -> logging.Logger:
    """Logger factory. Env overrides: TPU_SLAM_LOG_LEVEL, TPU_SLAM_LOG_JSON."""
    logger = logging.getLogger(name)
    if getattr(logger, "_tpu_slam_configured", False):
        return logger
    level = level or os.environ.get("TPU_SLAM_LOG_LEVEL", "INFO")
    if json_lines is None:
        json_lines = os.environ.get("TPU_SLAM_LOG_JSON", "0") == "1"
    handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level.upper())
    logger.propagate = False
    logger._tpu_slam_configured = True  # type: ignore[attr-defined]
    return logger


def log_fields(logger: logging.Logger, level: int, msg: str, **fields):
    """Log with structured fields (appear as JSON keys in json mode)."""
    logger.log(level, msg, extra={"fields": fields})
