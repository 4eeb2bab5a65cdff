"""A sync-free body captured once into a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` for its compiled programs (the dense
engine's step, the pose-graph solve). ``Captured(fn, device)`` runs ``fn``
once on a side stream (the warm-up PyTorch asks for: the libraries'
handles and workspaces and the nvcc build of a kernel come up there),
then records it into a ``torch.cuda.CUDAGraph`` on that stream.
``replay()`` runs the recorded work again on the current stream and
returns ``fn``'s outputs: the same tensors at every replay. ``fn`` reads
and writes tensors it closes over (static buffers), so the caller copies
its inputs into those before a replay and copies out what it keeps.

A capture or a replay that fails raises; nothing falls back to running
``fn`` eagerly. The capture is ``thread_local``: another thread (the live
chain's poller) may use the device meanwhile.

Kernel wrappers count their calls where they launch, which inside ``fn``
happens at the capture, not at a replay: ``calls`` holds, for each wrapper
passed in ``counters``, the calls one replay makes, and the class's
``recorded`` and ``replayed`` tally, by wrapper name, the calls recorded
at captures (which launched nothing) and the calls that replays launched.
A wrapper's launches are then ``launches - recorded + replayed``
(``kernel_launches``).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Sequence

import torch


class Captured:
    """``fn`` as one CUDA graph on ``device`` (see the module docstring)."""

    recorded: Counter = Counter()
    replayed: Counter = Counter()

    def __init__(self, fn: Callable, device, counters: Sequence = ()):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        t0 = time.perf_counter()
        held0 = torch.cuda.memory_allocated(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn()
        before = [c.launches for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = fn()
        self.calls: Dict[str, int] = {
            c.__name__: c.launches - b for c, b in zip(counters, before)}
        Captured.recorded.update(self.calls)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # what the graph keeps: its outputs and the memory of its pool
        self.held_bytes = torch.cuda.memory_allocated(dev) - held0
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        Captured.replayed.update(self.calls)
        return self.outputs


def kernel_launches(wrapper) -> int:
    """The kernel launches of ``wrapper`` (a function with a ``launches``
    count): its eager calls plus the calls that graph replays made."""
    name = wrapper.__name__
    return (wrapper.launches - Captured.recorded[name]
            + Captured.replayed[name])


def reset_kernel_launches(*wrappers) -> None:
    """Set the counts of ``wrappers``, and the graphs' tallies of them, to
    0."""
    for w in wrappers:
        w.launches = 0
        Captured.recorded.pop(w.__name__, None)
        Captured.replayed.pop(w.__name__, None)
