"""Scan-to-map registration: NDT on the dense-window kernel path."""
