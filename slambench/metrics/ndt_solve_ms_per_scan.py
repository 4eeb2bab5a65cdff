"""Device time of the dense step's stage ``solve``, the solves (the yaw search
and the LM iterations, ndt_terms included), a scan over the traced stretch
(ms): the union of the intervals of the device operations between each
``span_mark<stage_solve>`` and the next mark."""

from slambench.metrics._marks import ms_per_scan


def read(t):
    return ms_per_scan(t, "solve")
