"""Device time of the dense step's stage ``raster``, the terms rasters (every
build_terms_raster, the yaw candidates' and each re-bin's), a scan over the
traced stretch (ms): the union of the intervals of the device operations
between each ``span_mark<stage_raster>`` and the next mark."""

from slambench.metrics._marks import ms_per_scan


def read(t):
    return ms_per_scan(t, "raster")
