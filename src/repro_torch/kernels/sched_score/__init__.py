"""Fused score + ranking kernels for the ordering layer (CUDA, sm_90a).

  sched_score.cu  the hand kernels (top-b, argmax, compaction + top-b)
  ops.py          checked wrappers: CUDA tensors launch the kernels,
                  CPU tensors take the plain versions; launch counts
  ref.py          the plain PyTorch versions
"""
from repro_torch.kernels.sched_score.ops import (  # noqa: F401
    LAUNCHES,
    reset_launches,
    sched_compact_topb,
    sched_score_argmax,
    sched_score_topb,
)
