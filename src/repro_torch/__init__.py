"""PyTorch + CUDA port of the client-side scheduler stack (`repro`) and
of the serving engine it schedules against.

The JAX package (`src/repro/`) is the reference; this package mirrors
its layout (`core/`, `sim/`, `kernels/`, `configs/`, `models/`,
`serving/`) and names so each module's counterpart is easy to find.
It imports `torch`, `numpy` and the standard library only — never
`jax` and nothing of `repro`.

Every entry point takes an explicit `device=` that defaults to CUDA and
raises when no card is present unless the caller asks for the CPU
(`device="cpu"`), which is how the tests run it.
"""
from repro_torch.device import resolve_device  # noqa: F401
