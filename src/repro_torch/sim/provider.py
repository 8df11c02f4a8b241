"""Congestion-aware mock provider (paper §4.1), stationary physics.

Counterpart of the stationary part of `repro.sim.provider`: service
time is linear in output tokens and multiplied by a convex load factor
once the provider is driven past its comfortable concurrency.  The
brownout, rate-limit and fleet dynamics are not part of this package
yet (ROADMAP queue A).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.numerics import pinned


class ProviderPhysics(NamedTuple):
    base_ms: torch.Tensor              # () float32 fixed per-request overhead
    ms_per_token: torch.Tensor         # () float32 linear generation cost
    comfort_concurrency: torch.Tensor  # () float32 knee of the slowdown curve
    slowdown_slope: torch.Tensor       # () float32 linear excess-load penalty
    slowdown_quad: torch.Tensor        # () float32 quadratic penalty


def default_physics(
    base_ms: float = 90.0,
    ms_per_token: float = 6.5,
    comfort_concurrency: float = 4.0,
    slowdown_slope: float = 0.8,
    slowdown_quad: float = 0.5,
) -> ProviderPhysics:
    def f(x):
        return torch.tensor(x, dtype=torch.float32)

    return ProviderPhysics(
        f(base_ms), f(ms_per_token), f(comfort_concurrency),
        f(slowdown_slope), f(slowdown_quad),
    )


def load_multiplier(phys: ProviderPhysics, inflight) -> torch.Tensor:
    """Convex slowdown once offered load passes the comfort knee."""
    comfort = phys.comfort_concurrency
    excess = torch.clamp(inflight.float() - comfort, min=0.0) / torch.clamp(
        comfort, min=1.0)
    return 1.0 + phys.slowdown_slope * excess + phys.slowdown_quad * (
        excess * excess)


def unloaded_latency_ms(phys: ProviderPhysics, tokens) -> torch.Tensor:
    return phys.base_ms + pinned(phys.ms_per_token * tokens)


def service_time_ms(phys: ProviderPhysics, tokens, inflight, jitter
                    ) -> torch.Tensor:
    """Realized service time for a request admitted with `inflight` jobs
    outstanding; `jitter` is per-request noise (~U[0.95, 1.05])."""
    return (unloaded_latency_ms(phys, tokens) * load_multiplier(phys, inflight)
            * jitter)
