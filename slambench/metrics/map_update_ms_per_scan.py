"""Device time of the dense step's stage ``map``, the windows' updates (both
grid_scroll calls and both grid_insert calls), a scan over the traced
stretch (ms): the union of the intervals of the device operations between
each ``span_mark<stage_map>`` and the next mark."""

from slambench.metrics._marks import ms_per_scan


def read(t):
    return ms_per_scan(t, "map")
