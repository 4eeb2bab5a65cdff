"""Profiling harness: a torch.profiler trace, timing, named regions.

Port of ``tpu_slam.utils.tracing``. ``profile_trace`` wraps a code region
in a ``torch.profiler`` trace of the host and the card, written as a Chrome
trace (open it in Perfetto or TensorBoard); ``time_jitted`` times a
callable the right way (warm-up excluded, the result's device
synchronised); ``KernelTimer`` accumulates named region times for the
per-scan metrics stream.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict

import torch


def _devices_of(result: Any):
    """The CUDA devices of every tensor in ``result`` (nested in lists,
    tuples, dicts and dataclasses)."""
    out = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                out.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(result)
    return out


def block_until_ready(result: Any) -> Any:
    """Wait for the devices that hold ``result``'s tensors (a CPU tensor is
    ready when it is returned); returns ``result``."""
    for dev in _devices_of(result):
        torch.cuda.synchronize(dev)
    return result


@contextlib.contextmanager
def profile_trace(logdir: str, with_memory: bool = False):
    """Trace the enclosed region with torch.profiler (the host, and CUDA
    when there is a card) into ``logdir``/trace-<pid>-<ns>.json.

    Open the file in Perfetto (ui.perfetto.dev) or TensorBoard's profile
    plugin. When the profiler cannot start (another trace is active: a
    second one would not start, and torch's profiler may crash the process
    trying) the region runs untraced, as in the reference, and the context
    yields None.
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    if not torch.autograd._profiler_enabled():
        try:
            prof = profile(activities=acts, profile_memory=with_memory)
            prof.__enter__()
        except RuntimeError:
            prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(logdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
            except (OSError, RuntimeError):
                pass


def time_jitted(fn: Callable[..., Any], *args, reps: int = 20,
                warmup: int = 2, **kwargs) -> Dict[str, float]:
    """Wall-time a callable: warm up, then ``reps`` calls each ended by a
    synchronisation of the devices its result lives on.

    Returns {"mean_ms", "p50_ms", "min_ms", "reps"}.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "mean_ms": 1e3 * sum(times) / len(times),
        "p50_ms": 1e3 * times[len(times) // 2],
        "min_ms": 1e3 * times[0],
        "reps": reps,
    }


class KernelTimer:
    """Named-region wall timers feeding the metrics stream.

    Usage::

        timer = KernelTimer()
        with timer("downsample", result=scan):
            ...
        timer.summary()  # {"downsample": {"total_s": ..., "count": ...}}

    With ``sync`` a region waits, on exit, for the devices of the
    ``result`` it was given, so the numbers mean something under
    asynchronous launches.
    """

    def __init__(self, sync: bool = True):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync and result is not None:
                block_until_ready(result)
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self._totals[k], "count": self._counts[k],
                    "mean_ms": 1e3 * self._totals[k] / max(self._counts[k], 1)}
                for k in self._totals}

    def reset(self):
        self._totals.clear()
        self._counts.clear()
