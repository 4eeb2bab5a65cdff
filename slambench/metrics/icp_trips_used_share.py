"""Share of the loop verification's batched ICP trips that did work over
the traced stretch: the iterations of every pair in both directions (the
device counter ``icp_trips_used``, the sum of ``ICPResult.iterations``)
over pairs x trips run (the host counter ``icp_trips_run``), from the
program's recorder (``tpu_slam_torch.utils.tracing.counters``)."""


def read(t):
    try:
        from tpu_slam_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    run = c.get("icp_trips_run", 0)
    if run <= 0:
        return None
    return c.get("icp_trips_used", 0) / run
