"""Host-clock seconds of ``SLAMSystem.stage_seconds['keyframe']``, the keyframe
store (its graph replay and the normals' eigh), over the unprofiled stretch,
divided by its keyframes (ms)."""


def read(t):
    n = t.stage_counts.get("keyframes", 0)
    if n == 0 or "keyframe" not in t.stages:
        return None
    return 1e3 * t.stages["keyframe"] / n
