"""Ports of the repo's gather probes (``benchmarks/``) onto the kernels of
``kernels/gather.py``. Each module has a ``main(device)`` that runs its
variants at the original sizes and returns their times and checks."""
