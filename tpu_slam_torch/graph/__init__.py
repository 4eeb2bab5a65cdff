"""SLAM backend: pose graph, loop-closure candidates and verification."""
