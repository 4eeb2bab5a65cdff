"""Device-idle time inside the loop sweeps of the traced stretch, per
sweep (ms): for each of the program recorder's ``sweep`` spans
(``SLAMSystem._close_loops``; ``tpu_slam_torch.utils.tracing.spans``, on
the profiler's clock), its length less the union of the device
operations' intervals inside it. It holds the CG flag reads, the
verification's read-back and the host's candidate proposal. None without
sweeps or without device operations."""

import bisect

from slambench.trace import _union


def read(t):
    try:
        from tpu_slam_torch.utils.tracing import spans
    except ImportError:
        return None
    sweeps = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans()
              if s.name == "sweep"]
    if not sweeps or t.busy_s <= 0:
        return None
    busy = _union([(s, e) for _, s, e in t.device_ops])
    ends = [e for _, e in busy]
    idle = 0.0
    for a, b in _union(sweeps):
        inside = 0.0
        for s, e in busy[bisect.bisect_right(ends, a):]:
            if s >= b:
                break
            inside += min(e, b) - max(s, a)
        idle += (b - a) - inside
    return 1e3 * idle / len(sweeps)
