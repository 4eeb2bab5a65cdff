"""The traced stretch: what ``torch.profiler`` saw, reduced for the readers.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities), keeps the trace in memory and reduces it to a ``Trace``:
every device operation's interval and name, the counts of the host's
runtime calls, the union of the device intervals (``busy_s``) and the
longest gaps in it, each named by the innermost host operation that was
running at its middle. The per-layer readers in ``slambench/metrics``
take their numbers from a ``Trace`` and the counters the driver kept.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

# host calls that put work on the device or wait for it
HOST_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
              "cudaLaunchKernelExC", "cudaGraphLaunch", "cuGraphLaunch",
              "cudaMemcpyAsync", "cudaMemcpy", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaEventSynchronize")
SCAN_BACK = 20000
# a kernel's name in the trace carries its template arguments
NAME_CHARS = 200


@dataclasses.dataclass
class Trace:
    """One traced stretch of whole scans, with the driver's counters."""

    scans: int                       # scans in the traced stretch
    window_s: float                  # its length on the host clock
    device_ops: List[Tuple[str, float, float]]   # (name, start s, end s)
    host_counts: Dict[str, int]      # host events by name
    busy_s: float = 0.0              # union of the device intervals
    gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    # the driver's counters over the traced stretch (sweeps, ...)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    # over the unprofiled window before it: stage seconds and the scans,
    # keyframes, sweeps and solves they were spent on
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    stage_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def device_seconds(self, names) -> float:
        """Summed device time of the operations whose name contains one of
        ``names`` (a kernel's name in the trace carries its signature)."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> List[List]:
        """The k device operations that took most time: [name (its first
        NAME_CHARS characters), seconds]."""
        by = Counter()
        for n, s, e in self.device_ops:
            by[n] += e - s
        return [[n[:NAME_CHARS], t] for n, t in by.most_common(k)]


def _events(prof):
    """(name, is_device, start s, end s) of every event in the trace."""
    from torch.autograd import DeviceType

    kr = getattr(prof.profiler, "kineto_results", None)
    if kr is not None:
        for e in kr.events():
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            yield e.name(), e.device_type() == DeviceType.CUDA, s, s + d
        return
    for e in prof.events():
        yield (e.name, e.device_type == DeviceType.CUDA,
               e.time_range.start * 1e-6, e.time_range.end * 1e-6)


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, scans: int, window_s: float, n_gaps: int = 10) -> Trace:
    dev, host = [], []
    counts = Counter()
    for name, is_dev, s, e in _events(prof):
        if is_dev:
            dev.append((name, s, e))
        else:
            host.append((s, e, name))
            counts[name] += 1
    merged = _union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:n_gaps]
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        best: Optional[Tuple[float, str]] = None
        # the innermost host event running at the gap's middle, among the
        # SCAN_BACK events that start last before it
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - SCAN_BACK), -1):
            hs, he, hn = host[j]
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, hn)
        named.append((best[1][:NAME_CHARS] if best else "no host event",
                      length))
    return Trace(scans=scans, window_s=window_s, device_ops=dev,
                 host_counts=dict(counts), busy_s=busy, gaps=named)


def profiled(fn: Callable[[], int]) -> Trace:
    """Run ``fn`` (which returns the scans it ran, each ending with its
    pose on the host) under the profiler; the trace stays in memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        scans = fn()
        window_s = time.perf_counter() - t0
    return reduce(prof, scans, window_s)
