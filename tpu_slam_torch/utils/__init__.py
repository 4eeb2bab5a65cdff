"""Cross-cutting utilities: tracing and timing (tracing, devtime),
structured logging, the PLY writer."""

from tpu_slam_torch.utils.logging import get_logger
from tpu_slam_torch.utils.tracing import profile_trace, time_jitted

__all__ = ["profile_trace", "time_jitted", "get_logger"]
