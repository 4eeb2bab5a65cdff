"""Odometry pipeline: configuration, metrics, the dense engine, state I/O."""
