"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

Each kernel package holds `ref.py` (the plain version) and `ops.py` (the
wrapper: a CPU tensor runs the plain version, a CUDA tensor launches the
kernel or raises). `_build.py` compiles the CUDA sources with nvcc.
"""
