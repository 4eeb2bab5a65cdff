"""Core math: SE(3), symmetric 3x3 closed forms, padded point clouds."""
