"""Host-clock seconds of ``SLAMSystem.stage_seconds['graph']``, the graph solve
(``optimize_pose_graph``), over the unprofiled stretch, divided by its
solves (ms)."""


def read(t):
    n = t.stage_counts.get("solves", 0)
    if n == 0 or "graph" not in t.stages:
        return None
    return 1e3 * t.stages["graph"] / n
