"""Mamba2 SSD intra-chunk step (CUDA, sm_90a).

  ssd_scan.cu  the hand kernel
  ops.py       checked wrapper: CUDA tensors launch the kernel, CPU
               tensors take the plain version; launch count
  ref.py       the plain PyTorch version
"""
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    ssd_intra,
)
