"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` is the entry point (the counterpart of ``repro.kernels.ops``);
``halo_pack``, ``rmsnorm``, ``flash_attention`` and ``ssd_scan`` hold
the wrappers (CUDA for CUDA tensors, the plain version of ``ref`` for
CPU tensors) and launch counters; ``build`` compiles ``csrc/`` with
nvcc at first use.
"""
