"""Device time of the dense step's stage ``prep``, the preparation of the scan
(the prediction's clamp, the deskew, both voxel downsamples and the range
gate), a scan over the traced stretch (ms): the union of the intervals of
the device operations between each ``span_mark<stage_prep>`` and the next
mark."""

from slambench.metrics._marks import ms_per_scan


def read(t):
    return ms_per_scan(t, "prep")
