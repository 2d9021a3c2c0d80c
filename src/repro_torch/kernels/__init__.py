"""Hand-written Hopper kernels of the port and their plain versions.

``halo_pack`` holds the wrappers (CUDA for CUDA tensors, the plain
version of ``ref`` for CPU tensors) and launch counters; ``build``
compiles ``csrc/`` with nvcc at first use.
"""
