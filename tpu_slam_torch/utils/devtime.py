"""Timing on the card: the slope of a K-iteration loop, and per-call times.

Port of ``tpu_slam.utils.devtime`` (``slope_time``). A loop of K
data-dependent iterations (each iteration's input derives from the
previous result) is timed at two
values of K on the host clock, with the device synchronised at both ends of
each run:

    t_per_iteration = (t(K2) - t(K1)) / (K2 - K1)

Fixed costs (the first launch, the final copy to the host) cancel in the
difference. Both K are run once before the timed runs, so a kernel built at
first use never enters the measurement.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from tpu_slam_torch import default_device


def slope_time(loop_fn: Callable[[int], object], k1: int = 5, k2: int = 45,
               device=None) -> float:
    """Seconds per iteration of ``loop_fn(K)``, a K-iteration loop.

    ``loop_fn`` runs its K iterations on ``device`` (CUDA unless the caller
    asks for the CPU) and returns something that depends on every one of
    them.
    """
    dev = default_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(k):
        sync()
        t0 = time.perf_counter()
        loop_fn(k)
        sync()
        return time.perf_counter() - t0

    run(k1)
    run(k2)
    ta = run(k1)
    tb = run(k2)
    return max((tb - ta) / (k2 - k1), 1e-9)


def device_label(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type: every
    timing names the device it was taken on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def call_ms(fn: Callable[[], object], reps: int = 20, device=None) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` back-to-back calls,
    after one warm-up call: CUDA-event time on the card, the host clock on
    the CPU."""
    dev = default_device(device)
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps
