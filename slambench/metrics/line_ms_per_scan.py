"""Host-clock time of the live chain's line work a scan (ms): the spans
``live.line`` (``LivePipeline.feed_line``: the line's staging, its copy,
its graph replay and the scan-complete read) over the unprofiled window,
divided by its scans."""

from slambench.metrics._spans import ms_per


def read(t):
    return ms_per(t, "live.line")
