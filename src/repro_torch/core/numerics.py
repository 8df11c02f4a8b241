"""Float determinism helpers.

`pinned(x)` is the identity.  The reference wraps
`lax.optimization_barrier` so that XLA rounds the same subgraph the
same way in two differently shaped programs; eager PyTorch runs one
kernel per operation and fuses nothing, so every op already rounds on
its own.  The call stays at the same places as in the reference: it
marks where rounding is pinned, and the linter's pinned-float rule
reads it.

`fma32(a, b, c)` is a single-rounded `a*b + c` in float32, computed in
float64 (the f32 product is exact there) and rounded once — the same
emulation as the reference's `client/provider.py` `_fma32` of the FMA
that XLA:CPU emits for the engine's `service * jitter + now`.  It gives
the same bits on the CPU and on CUDA.

`sum32(x)` sums a float32 tensor in float64 and rounds once, so the
result does not depend on the device's reduction order.
"""
from __future__ import annotations

import torch


def pinned(x):
    """Identity: marks a value whose rounding is pinned."""
    return x


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Single-rounded float32 `a * b + c` (via float64)."""
    return (a.double() * b.double() + c.double()).float()


def sum32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Order-independent float32 sum: accumulate in float64, round once."""
    if dim is None:
        return x.double().sum().float()
    return x.double().sum(dim=dim).float()
