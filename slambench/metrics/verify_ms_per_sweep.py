"""Host-clock seconds of ``SLAMSystem.stage_seconds['verify']``, the loop
verification (candidates and the batched ICP), over the unprofiled stretch,
divided by its sweeps (ms)."""


def read(t):
    n = t.stage_counts.get("sweeps", 0)
    if n == 0 or "verify" not in t.stages:
        return None
    return 1e3 * t.stages["verify"] / n
