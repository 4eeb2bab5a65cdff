"""The benchmark's plain reference: frozen copies of the port's plain
paths (``tpu_slam_torch`` at the commit that added the benchmark), eager,
with host-exit loops and no kernel of the program, and the step and loop
sweep re-computed from them (``odometry.py``, ``sweep.py``). Nothing here
imports the program."""
