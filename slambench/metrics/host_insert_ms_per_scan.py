"""Host-clock time of the host engine's map insert a scan (ms): the spans
``host.insert`` (``insert_cloud`` and its overflow read) over the
unprofiled window, divided by its scans."""

from slambench.metrics._spans import ms_per


def read(t):
    return ms_per(t, "host.insert")
