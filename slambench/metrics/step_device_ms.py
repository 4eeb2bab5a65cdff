"""Device time of one step: the union of every device operation's
interval over the traced stretch, divided by its scans (ms)."""


def read(t):
    if t.busy_s <= 0 or t.scans == 0:
        return None
    return 1e3 * t.busy_s / t.scans
