"""Share of the dense step's LM trips that did work over the traced
stretch: the iterations whose loop condition held, coarse and fine (the
device counter ``ndt_lm_iters_used``), over the trips the captured step
ran (``ndt_lm_iters_run``), from the program's recorder
(``tpu_slam_torch.utils.tracing.counters``)."""


def read(t):
    try:
        from tpu_slam_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    run = c.get("ndt_lm_iters_run", 0)
    if run <= 0:
        return None
    return c.get("ndt_lm_iters_used", 0) / run
