"""Host-clock time of one NDT field build of the host engine (ms): the
spans ``host.field`` (the dense field window from the sparse map, closed
on a device synchronisation) over the unprofiled window, divided by the
builds in it (``host_field_builds``, the driver's count of those
spans)."""

from slambench.metrics._spans import ms_per


def read(t):
    return ms_per(t, "host.field", "host_field_builds")
