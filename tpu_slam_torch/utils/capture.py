"""A sync-free body captured once into a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` for its compiled programs: the dense
engine's step, the pose-graph PCG solve, ``ndt_register`` (the host
engine's registrations, config 3), ``JitLidarOdometry``'s step,
``icp_raster`` and the batched ``icp``, the map insert, the keyframe
store, the live chain's scan line, the SLAM sweep's map and grid rebuilds
and ``sc_distance``, the host engine's options (``coarsen_map``,
``occupancy_maintain``, ``deskew_cloud``), the calibration's
``overlap_cost`` and gradient step, the Schur pose-graph solve and
``optimize_pose_graph``'s dense solver, the sharded dense step and the
synthetic ray caster.
``Captured(fn, device)`` runs ``fn`` once on a side stream (the warm-up
PyTorch asks for: the libraries' handles and workspaces and the nvcc build
of a kernel come up there), then records it into a ``torch.cuda.CUDAGraph``
on that stream. ``replay()`` runs the recorded work again on the current
stream and returns ``fn``'s outputs: the same tensors at every replay.
``fn`` reads and writes tensors it closes over (static buffers), so the
caller copies its inputs into those before a replay and copies out what it
keeps. ``CapturedCall(fn, args)`` does that for a function of tensors,
dataclasses of them, tuples and lists: its static inputs are copies of
``args``' tensors, a call copies the new arguments into them, replays and
returns copies of the outputs. ``replay(cache, fn, args, static)`` keeps
one for each ``signature((args, static))``: the structure, each tensor's
shape, strides, dtype and device (a kernel's choice, and so its bits, may
follow the strides) and the other values (specs, parameters, window
dims); ``compiled_call`` is ``replay`` on a CUDA device and ``fn`` run
eagerly elsewhere. ``CapturedStep(fn, state, args)`` is for a
``fn(state, *args)`` that updates ``state``'s tensors in place (the
aggregator's line): the graph's state is a static copy that each call
returns, and a call copies a state in only when it is not the graph's
own.

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

import dataclasses
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Sequence

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
        # the capture frees the allocator's cached blocks before it starts;
        # done here first, the reserved memory it adds is its pool's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        before = [c.launches for c in counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = fn()
        self.calls: Dict[str, int] = {
            c.__name__: c.launches - b for c, b in zip(counters, before)}
        Captured.recorded.update(self.calls)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # what the graph keeps: its outputs (allocated), and the segments
        # its private pool reserved for them and its intermediates
        self.held_bytes = torch.cuda.memory_allocated(dev) - held0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
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


def tensors_of(obj) -> List[torch.Tensor]:
    """The tensors of ``obj`` (a tensor, or a dataclass, tuple or list of
    them, nested) in field order; None and other values hold none."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in tensors_of(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def with_tensors(template, tensors: Sequence[torch.Tensor]):
    """``template``'s structure over ``tensors`` (in ``tensors_of``'s
    order)."""
    it = iter(tensors)

    def rebuild(obj):
        if isinstance(obj, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: rebuild(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        if isinstance(obj, (tuple, list)):
            return type(obj)(rebuild(x) for x in obj)
        return obj

    return rebuild(template)


def signature(obj) -> Any:
    """A hashable description of ``obj``: its structure, each tensor's
    shape, strides, dtype and device, and its other values as they are."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.stride(), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            signature(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return tuple(signature(x) for x in obj)
    return obj


class CapturedCall:
    """``fn(*args)`` as one CUDA graph for ``args``' signature: static
    copies of their tensors are its inputs. A call copies its arguments
    (of the same signature) into them, replays, and returns copies of the
    outputs, so nothing it returns changes at the next replay."""

    def __init__(self, fn: Callable, args: Sequence, counters: Sequence = ()):
        tensors = tensors_of(args)
        self.inputs = [t.clone() for t in tensors]
        template = with_tensors(tuple(args), self.inputs)
        self.graph = Captured(lambda: fn(*template), tensors[0].device,
                              counters=counters)

    def __call__(self, *args):
        srcs = tensors_of(args)
        if len(srcs) != len(self.inputs):
            raise ValueError("a captured call's arguments must have the "
                             "signature it was captured for")
        for dst, src in zip(self.inputs, srcs):
            dst.copy_(src)
        out = self.graph.replay()
        return with_tensors(out, [t.clone() for t in tensors_of(out)])


def replay(cache: Dict, fn: Callable, args: Sequence, static: Any = (),
           counters: Sequence = ()):
    """``fn(*args)`` replayed from ``cache``'s ``CapturedCall`` for the
    signature of ``args`` and ``static`` (what else ``fn`` depends on),
    captured at its first request."""
    key = signature((tuple(args), static))
    cap = cache.get(key)
    if cap is None:
        cap = cache[key] = CapturedCall(fn, args, counters=counters)
    return cap(*args)


def compiled_call(cache: Dict, fn: Callable, args: Sequence,
                  static: Any = (), counters: Sequence = ()):
    """``fn(*args)``: ``replay``'s graph on a CUDA device; on another
    device ``fn`` itself, run eagerly (the sync-free body the graph
    records)."""
    if tensors_of(args)[0].device.type != "cuda":
        return fn(*args)
    return replay(cache, fn, args, static=static, counters=counters)


class CapturedStep:
    """``fn(state, *args)``, which updates ``state``'s tensors in place, as
    one CUDA graph over static copies of ``state`` and ``args``. A call
    copies its arguments in, and its state too unless the state is the
    one the graph updates (what the last call returned), replays, and
    returns that state: its tensors change at the next call."""

    def __init__(self, fn: Callable, state, args: Sequence):
        self.state = with_tensors(state,
                                  [t.clone() for t in tensors_of(state)])
        self.inputs = [t.clone() for t in tensors_of(args)]
        template = with_tensors(tuple(args), self.inputs)
        # the warm-up run updates the static state; the first call copies
        # the caller's state in (it is never the graph's own)
        self.graph = Captured(lambda: fn(self.state, *template),
                              self.inputs[0].device)

    def __call__(self, state, *args):
        srcs = tensors_of(args)
        if len(srcs) != len(self.inputs):
            raise ValueError("a captured step's arguments must have the "
                             "signature it was captured for")
        for dst, src in zip(self.inputs, srcs):
            dst.copy_(src)
        mine, theirs = tensors_of(self.state), tensors_of(state)
        if any(a is not b for a, b in zip(mine, theirs)):
            for dst, src in zip(mine, theirs):
                dst.copy_(src)
        self.graph.replay()
        return self.state
