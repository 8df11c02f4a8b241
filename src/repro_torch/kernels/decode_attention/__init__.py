"""Flash-decode: one query token against a masked KV cache (CUDA,
sm_90a, split-KV with a combine pass).

  decode_attention.cu  the hand kernels
  ops.py               checked wrapper: CUDA tensors launch the kernels,
                       CPU tensors take the plain version; launch count
  ref.py               the plain PyTorch version
"""
from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    LAUNCHES,
    decode_attention,
    reset_launches,
)
