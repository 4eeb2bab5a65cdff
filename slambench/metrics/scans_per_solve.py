"""Scans handed over in the unprofiled window for each graph solve in it:
the loop-closure work that ``scans_per_s`` was paid with. A solve is most
of a sweep step, so a run that admits fewer loops runs faster with the
same code; this reads that it did less."""


def read(t):
    n = t.stage_counts.get("solves", 0)
    if n == 0:
        return None
    return t.stage_counts["scans"] / n
