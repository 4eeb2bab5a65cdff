"""The benchmark of ``tpu_slam_torch``, the PyTorch and CUDA port.

``BENCHMARK.json`` at the repository's root names the cells; each is a
configuration (``configs/<name>.json``: the system under test, its
settings, the world and the sensor) under a traffic mix
(``traffic/<name>.json``: the route and how its scans are fed).
``run.py`` runs one cell once; ``world.py`` makes its scans on the card;
``systems/<name>.py`` drives an entry point and judges what it returned
against the plain reference in ``reference/``; ``metrics/<name>.py``
reads one per-layer metric from ``trace.py``'s reduction of the traced
stretch; ``control.py`` holds the runs that have to come out not
correct. Nothing here imports JAX or the JAX package.
"""
