"""Timing helpers (devtime)."""
