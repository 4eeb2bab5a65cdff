"""Share of the traced stretch in which no device operation ran:
1 - busy / window."""


def read(t):
    if t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
