"""Voxel hashing, downsampling and the CUDA kernels with their plain
versions: NDT terms, brute-force NN, ICP terms, row gathers (csrc/)."""
