"""Voxel hashing, downsampling and the NDT terms kernel (csrc/ndt_terms.cu)."""
