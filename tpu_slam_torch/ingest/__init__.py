"""Data sources: synthetic worlds and the VLP-16 simulator."""
