"""Registration: NDT on the dense-window kernel path, ICP (brute-force and
raster tiers), normals, robust weights."""
