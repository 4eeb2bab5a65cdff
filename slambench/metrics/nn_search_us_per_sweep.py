"""Device time of the brute-force NN kernels (``csrc/nn_search.cu``) a
loop sweep over the traced stretch (us)."""

KERNELS = ("nn_search_kernel", "nn_search_merge_kernel")


def read(t):
    sweeps = t.counts.get("sweeps", 0)
    s = t.device_seconds(KERNELS)
    if sweeps == 0 or s <= 0:
        return None
    return 1e6 * s / sweeps
