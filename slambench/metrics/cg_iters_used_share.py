"""Share of the PCG graph solve's CG iterations that did work over the
traced stretch: the iterations whose condition dot(r, r) > cg_tolerance
held, summed on the device (the counter ``cg_iters_used``), over the
iterations the replayed chunks ran (the host counter ``cg_iters_run``),
from the program's recorder (``tpu_slam_torch.utils.tracing.counters``).
None when the stretch solved nothing."""


def read(t):
    try:
        from tpu_slam_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    run = c.get("cg_iters_run", 0)
    if run <= 0:
        return None
    return c.get("cg_iters_used", 0) / run
