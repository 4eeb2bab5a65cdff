"""Host-clock time of the host engine's registration a scan (ms): the
spans ``host.register`` (``LidarOdometry._track``: the NDT registrations
and the one read of the gating decisions) over the unprofiled window,
divided by its scans."""

from slambench.metrics._spans import ms_per


def read(t):
    return ms_per(t, "host.register")
