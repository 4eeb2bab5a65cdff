"""Per-layer metric readers: ``<name>.py`` reads the metric ``<name>``.

Each defines ``read(trace)``: the metric's value from a
``slambench.trace.Trace`` (device operations and host calls of the traced
stretch, the driver's counters), or None where the stretch holds nothing
to read, and the harness then leaves the metric out of the result line.
"""
