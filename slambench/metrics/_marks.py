"""Shared by the dense step's stage readers: the device time of each stage
of ``DenseLidarOdometry``'s step over a traced stretch.

The step places a stage mark, a one-thread kernel named
``span_mark<stage_<stage>>`` (``tpu_slam_torch/csrc/span_mark.cu``), at
each stage boundary; a device operation belongs to the stage whose mark
ran last before it started, and the stage ``end`` (the graph's copies and
the pose read after a step) to none. A program without the marks gives
no stage.
"""

from collections import defaultdict

from slambench.trace import _union

MARK = "span_mark<stage_"


def stage_seconds(t):
    """{stage: seconds of the union of its operations' intervals}."""
    spans = defaultdict(list)
    stage = None
    for name, s, e in sorted(t.device_ops, key=lambda op: op[1]):
        i = name.find(MARK)
        if i >= 0:
            j = i + len(MARK)
            stage = name[j:name.index(">", j)]
        elif stage is not None and stage != "end":
            spans[stage].append((s, e))
    return {k: sum(e - s for s, e in _union(v)) for k, v in spans.items()}


def ms_per_scan(t, stage):
    """``stage``'s device time a scan (ms); None without its marks."""
    if t.scans == 0:
        return None
    s = stage_seconds(t).get(stage)
    return None if s is None else 1e3 * s / t.scans
