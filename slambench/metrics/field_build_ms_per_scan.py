"""Device time of the dense step's stage ``field``, the NDT fields' builds
(both grid_ndt_field calls), a scan over the traced stretch (ms): the union
of the intervals of the device operations between each
``span_mark<stage_field>`` and the next mark."""

from slambench.metrics._marks import ms_per_scan


def read(t):
    return ms_per_scan(t, "field")
