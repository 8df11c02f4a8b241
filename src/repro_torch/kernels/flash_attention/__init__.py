"""Causal GQA flash attention for prefill (CUDA, sm_90a).

  flash_attention.cu  the hand kernel
  ops.py              checked wrapper: CUDA tensors launch the kernel,
                      CPU tensors take the plain version; launch count
  ref.py              the plain PyTorch version
"""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    reset_launches,
)
