"""Shared by the span readers: a span's milliseconds for each of a count
over the unprofiled window. The survey's driver adds up the program
recorder's spans of each stop (``tpu_slam_torch.utils.tracing``) and
carries their seconds under ``stages``, keyed by the span's name, and
the counts beside them; a program or a driver without them gives None."""


def ms_per(t, name, count="scans"):
    n = t.stage_counts.get(count, 0)
    if n <= 0 or name not in t.stages:
        return None
    return 1e3 * t.stages[name] / n
