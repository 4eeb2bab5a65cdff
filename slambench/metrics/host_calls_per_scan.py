"""Host runtime calls a scan over the traced stretch: kernel and graph
launches, copies and synchronisations (``slambench.trace.HOST_CALLS``)."""

from slambench.trace import HOST_CALLS


def read(t):
    if t.scans == 0:
        return None
    n = sum(t.host_counts.get(k, 0) for k in HOST_CALLS)
    if n == 0:
        return None
    return n / t.scans
