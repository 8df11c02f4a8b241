"""Hand-written Hopper kernels of the port.

Each kernel package holds `<pkg>.cu` (CUDA C++ for sm_90a with a plain
C interface), `ops.py` (the checked ctypes wrappers and launch counts)
and `ref.py` (the plain PyTorch version the wrappers use on the CPU and
the chip check holds the kernel against).  `_build.py` compiles the
sources with nvcc at first use.
"""
