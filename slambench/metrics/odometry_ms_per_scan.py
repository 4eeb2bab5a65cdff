"""Host-clock seconds of ``SLAMSystem.stage_seconds['odometry']``, the odometry
stage (``SLAMSystem.step``'s dense engine step and its pose read), over the
unprofiled stretch, divided by its scans (ms)."""


def read(t):
    n = t.stage_counts.get("scans", 0)
    if n == 0 or "odometry" not in t.stages:
        return None
    return 1e3 * t.stages["odometry"] / n
