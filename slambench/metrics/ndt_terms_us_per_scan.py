"""Device time of the NDT terms kernel and its finalizer
(``csrc/ndt_terms.cu``) a scan over the traced stretch (us)."""

KERNELS = ("ndt_terms_kernel", "ndt_terms_finalize")


def read(t):
    s = t.device_seconds(KERNELS)
    if s <= 0 or t.scans == 0:
        return None
    return 1e6 * s / t.scans
