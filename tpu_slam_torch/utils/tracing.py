"""Profiling harness, timing, and the port's span and counter recorder.

Port of ``tpu_slam.utils.tracing``. ``profile_trace`` wraps a code region
in a ``torch.profiler`` trace of the host and the card, written as a Chrome
trace (open it in Perfetto or TensorBoard); ``time_jitted`` times a
callable the right way (warm-up excluded, the result's device
synchronised).

The recorder (one a process) records while ``enable()`` is in force or a
``torch.profiler`` is active; each start of recording begins a new
stretch, and what it kept of the last one is dropped:

* ``span(name)`` keeps name, start and end (``time.time_ns()``, the clock
  the profiler's events carry), its own id, its parent's and the id of the
  scan step that caused it (the outermost span opened with ``step=True``).
  Under the profiler it is also a ``record_function`` range (of function
  scope: not mirrored onto the device's timeline), so it shows in the
  Chrome trace. While nothing records, a span costs one check.
* ``count(name, n)`` adds to a host counter while recording;
  ``device_count(name, n)`` adds ``n`` (a device tensor or an int) to a
  static int64 counter on the device, always, inside a CUDA graph too, so
  a replay sums it and nothing is read back (``device_counter`` hands a
  counter's tensor to a kernel that adds to it itself). ``counters()``
  gives the host counters and each device counter's change since the
  stretch began (one read of the device).
* Stage marks: inside ``stage_marks(device)`` (one scan step of the dense
  engine), ``mark(stage)`` opens one of ``STAGES``. On a CUDA device a
  mark is a one-thread kernel, ``span_mark<stage_...>``
  (``csrc/span_mark.cu``), that writes ``%globaltimer`` and its stage into
  its slot of a static buffer; the kernels are launched, or captured,
  whether or not anything records. On the CPU a mark only closes the last
  stage's span and opens the next one's (``dense.<stage>``), and only while
  recording. With ``enable()`` and no profiler, ``keep_marks`` copies the
  slots on the device after each step and ``flush_marks`` reads them all
  at once: each step's seconds by stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# the stages of a dense step, in csrc/span_mark.cu's order of ids; "end"
# closes the step (the graph's input and output copies and the pose read
# follow it)
STAGES = ("prep", "map", "field", "raster", "solve", "end")
# marks a step may place (slots of the static buffer, two int64 each)
MARK_SLOTS = 128


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
    plugin. The recorder's spans show in it as ranges. When the profiler
    cannot start (another trace is active: a second one would not start,
    and torch's profiler may crash the process trying) the region runs
    untraced, as in the reference, and the context yields None.
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


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span; times in ns on ``time.time_ns()``'s clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    step: Optional[int]


@dataclasses.dataclass(eq=False)
class _Open:
    name: str
    start_ns: int
    id: int
    parent: Optional[int]
    step: Optional[int]
    twin: Any       # the record_function range under the profiler, or None


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Recorder:
    """Spans and counters of the current recorded stretch (module
    docstring); the module's functions use the process's one instance."""

    def __init__(self):
        self.enabled = 0
        self.on = False
        self.started = False
        self.spans: List[Span] = []
        self.counts: Counter = Counter()
        self.device_counters: Dict[Tuple[str, torch.device],
                                   torch.Tensor] = {}
        self.baseline: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self.mark_slots: Dict[torch.device, torch.Tensor] = {}
        self.mark_history: List[torch.Tensor] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def recording(self) -> bool:
        on = self.enabled > 0 or torch.autograd._profiler_enabled()
        if on != self.on:
            if on:
                if _capturing():
                    # a capture records no copy: begin after it
                    return on
                self._begin()
            self.on = on
        return on

    def _begin(self) -> None:
        self.started = True
        self.spans = []
        self.counts = Counter()
        self.mark_history = []
        # copies on the device: the stretch's first span reads nothing back
        self.baseline = {k: t.clone()
                         for k, t in self.device_counters.items()}

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, step: bool = False) -> Optional[_Open]:
        """A new span under this thread's innermost open one, or None
        while nothing records."""
        if not self.recording():
            return None
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        step_id = parent.step if parent is not None else None
        if step_id is None and step:
            step_id = sid
        t0 = time.time_ns()
        twin = None
        if torch.autograd._profiler_enabled():
            # a function-scope range: a user annotation's would be mirrored
            # onto the device's timeline, as if the device were busy
            twin = torch._C._profiler._RecordFunctionFast(name)
            twin.__enter__()
        s = _Open(name, t0, sid, None if parent is None else parent.id,
                  step_id, twin)
        stack.append(s)
        return s

    def close(self, s: Optional[_Open]) -> None:
        if s is None:
            return
        stack = self._stack()
        if s in stack:
            stack.remove(s)
        if s.twin is not None:
            s.twin.__exit__(None, None, None)
        self.spans.append(Span(s.name, s.start_ns, time.time_ns(), s.id,
                               s.parent, s.step))

    def count(self, name: str, n: int) -> None:
        if self.recording():
            self.counts[name] += n

    def device_counter(self, name: str, device) -> torch.Tensor:
        key = (name, _key(device))
        c = self.device_counters.get(key)
        if c is None:
            if _capturing():
                raise RuntimeError(f"device counter {name!r} is made at a "
                                   "capture: run the body once eagerly "
                                   "first (Captured does)")
            c = self.device_counters[key] = torch.zeros(
                (), dtype=torch.int64, device=key[1])
        return c

    def counters(self) -> Dict[str, int]:
        """The host counters of the stretch and the device counters'
        change since it began; {} if nothing has recorded yet."""
        if not self.started:
            return {}
        out = dict(self.counts)
        for (name, dev), t in list(self.device_counters.items()):
            base = self.baseline.get((name, dev))
            v = int(t if base is None else t - base)
            out[name] = out.get(name, 0) + v
        return out

    def slots(self, device) -> torch.Tensor:
        dev = _key(device)
        s = self.mark_slots.get(dev)
        if s is None:
            if _capturing():
                raise RuntimeError("the mark slots are made at a capture: "
                                   "run the body once eagerly first")
            s = self.mark_slots[dev] = torch.zeros(
                MARK_SLOTS, 2, dtype=torch.int64, device=dev)
        return s


RECORDER = Recorder()


class _SpanContext:
    __slots__ = ("name", "step", "open")

    def __init__(self, name: str, step: bool):
        self.name, self.step, self.open = name, step, None

    def __enter__(self):
        self.open = RECORDER.open(self.name, self.step)
        return self

    def __exit__(self, *exc):
        RECORDER.close(self.open)
        return False


def recording() -> bool:
    """Whether spans and host counts are kept now."""
    return RECORDER.recording()


@contextlib.contextmanager
def enable():
    """Record while in force (the profiler's being active records too);
    entered while nothing records, it begins a new stretch."""
    if not (RECORDER.enabled or torch.autograd._profiler_enabled()):
        RECORDER.on = False
    RECORDER.enabled += 1
    try:
        RECORDER.recording()
        yield RECORDER
    finally:
        RECORDER.enabled -= 1


def span(name: str, step: bool = False) -> _SpanContext:
    """A span of the enclosed region; ``step`` makes it a scan step's own
    (its id becomes the step id of what it encloses) unless a step is
    open already."""
    return _SpanContext(name, step)


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while recording."""
    RECORDER.count(name, n)


def device_count(name: str, n, device=None) -> None:
    """Add ``n`` (a () tensor, or an int on ``device``) to the device
    counter ``name``: an add on the device, captured into a graph like any
    other, read only by ``counters``."""
    dev = n.device if isinstance(n, torch.Tensor) else device
    RECORDER.device_counter(name, dev).add_(n)


def device_counter(name: str, device) -> torch.Tensor:
    """The device counter ``name``'s () int64 tensor on ``device``, for a
    kernel that adds to it itself (as ``device_count`` would)."""
    return RECORDER.device_counter(name, device)


def spans() -> List[Span]:
    """The closed spans of the stretch, in the order they closed."""
    return list(RECORDER.spans)


def counters() -> Dict[str, int]:
    """The stretch's host counters and device counter changes."""
    return RECORDER.counters()


class _StepMarks:
    __slots__ = ("device", "n", "stage", "open")

    def __init__(self, device: torch.device):
        self.device, self.n, self.stage, self.open = device, 0, None, None


@contextlib.contextmanager
def stage_marks(device):
    """One scan step's stage marks on ``device`` (module docstring); its
    end places the mark "end"."""
    prev = getattr(RECORDER._local, "marks", None)
    RECORDER._local.marks = _StepMarks(torch.device(device))
    try:
        yield
    finally:
        mark("end")
        RECORDER._local.marks = prev


_launch_fn = None


def _launch_mark(stage: int, slots: torch.Tensor, slot: int) -> None:
    global _launch_fn
    import ctypes

    from tpu_slam_torch.kernels import _build

    if _launch_fn is None:
        _launch_fn = _build.bind("span_mark", "span_mark_launch",
                                 [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p])
    _build.launch("span_mark", _launch_fn, slots.device.index, stage,
                  slots.data_ptr(), slot)


def mark(stage: str) -> None:
    """Start ``stage`` (one of ``STAGES``) in the step that
    ``stage_marks`` opened on this thread; nothing outside one, nothing
    when the step is in that stage already."""
    m = getattr(RECORDER._local, "marks", None)
    if m is None or m.stage == stage:
        return
    sid = STAGES.index(stage)
    m.stage = stage
    if m.device.type == "cuda":
        if m.n >= MARK_SLOTS:
            raise RuntimeError(f"a step placed more than {MARK_SLOTS} "
                               "stage marks")
        _launch_mark(sid, RECORDER.slots(m.device), m.n)
        m.n += 1
        return
    RECORDER.close(m.open)
    m.open = None if stage == "end" else RECORDER.open(f"dense.{stage}")


def keep_marks(device) -> None:
    """After a step on ``device``: with ``enable()`` in force and no
    profiler, keep a copy (on the device) of its mark slots."""
    if (RECORDER.enabled and not torch.autograd._profiler_enabled()
            and RECORDER.recording()):
        s = RECORDER.mark_slots.get(_key(device))
        if s is not None:
            RECORDER.mark_history.append(s.clone())


def flush_marks() -> List[Dict[str, float]]:
    """Each kept step's seconds by stage (its marks' ``%globaltimer``
    differences), read in one copy; the kept copies are dropped."""
    hist, RECORDER.mark_history = RECORDER.mark_history, []
    if not hist:
        return []
    out = []
    for rows in torch.stack(hist).cpu().tolist():
        by: Dict[str, float] = {}
        for (t0, sid), (t1, _) in zip(rows, rows[1:]):
            if STAGES[sid] == "end":
                break
            by[STAGES[sid]] = by.get(STAGES[sid], 0.0) + 1e-9 * (t1 - t0)
        out.append(by)
    return out
