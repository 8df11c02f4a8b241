"""Congestion-aware mock provider (paper §4.1) and its dynamics.

Counterpart of `repro.sim.provider`: service time is linear in output tokens and multiplied by a convex load factor
once the provider is driven past its comfortable concurrency.

`ProviderDynamics` carries per-tick schedules that `run_sim` reads one
row a tick:

  * brownout windows: `comfort_scale[t]` multiplies the comfort
    concurrency, so the same inflight level slows service more inside
    the window;
  * per-class token-bucket rate limits: `tb_refill[t]` grants a tick
    per class against a `tb_capacity` burst; an admit that finds its
    bucket empty bounces 429-style and waits `retry_after_ms`.

A field is None when its mechanism is off.  The schedules are built on
the CPU in float32, with the reference's operations in its order, so
their bits equal the reference's (`sim/scenarios.py` `build`).

The fleet axis stacks the physics along P endpoints (`FleetPhysics`)
and gives each schedule a P axis (`FleetDynamics`), plus `avail`: an
endpoint whose availability is below 0.5 on a tick refuses new work
and kills its in-flight requests, which `run_sim` requeues.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def physics_for_arch(ms_per_token: float, base_ms: float = 90.0
                     ) -> ProviderPhysics:
    """Per-architecture provider: ms/token from the arch's decode cost."""
    return default_physics(base_ms=base_ms, ms_per_token=ms_per_token)


def load_multiplier(phys: ProviderPhysics, inflight, comfort_scale=None
                    ) -> torch.Tensor:
    """Convex slowdown once offered load passes the comfort knee.
    `comfort_scale` (a brownout value) multiplies the knee; None leaves
    the stationary arithmetic as it is.  The product and the subtraction
    round separately, on the CPU and on CUDA alike."""
    comfort = phys.comfort_concurrency
    if comfort_scale is not None:
        comfort = comfort * comfort_scale
    excess = torch.clamp(inflight.float() - comfort, min=0.0) / torch.clamp(
        comfort, min=1.0)
    return 1.0 + phys.slowdown_slope * excess + phys.slowdown_quad * (
        excess * excess)


def unloaded_latency_ms(phys: ProviderPhysics, tokens) -> torch.Tensor:
    return phys.base_ms + pinned(phys.ms_per_token * tokens)


def service_time_ms(phys: ProviderPhysics, tokens, inflight, jitter,
                    comfort_scale=None) -> torch.Tensor:
    """Realized service time for a request admitted with `inflight` jobs
    outstanding; `jitter` is per-request noise (~U[0.95, 1.05]).  A
    brownout's `comfort_scale` at admission inflates exactly the
    requests admitted inside its window."""
    return (unloaded_latency_ms(phys, tokens)
            * load_multiplier(phys, inflight, comfort_scale) * jitter)


# ---------------------------------------------------------------------------
# Time-varying provider dynamics
# ---------------------------------------------------------------------------

class ProviderDynamics(NamedTuple):
    """Per-tick provider schedules.  `comfort_scale` is None without a
    brownout; `tb_refill`/`tb_capacity`/`retry_after_ms` are None
    together without a rate limiter."""

    comfort_scale: Optional[torch.Tensor]   # (T,) brownout knee multiplier
    tb_refill: Optional[torch.Tensor]       # (T, K) grants refilled a tick
    tb_capacity: Optional[torch.Tensor]     # (K,) bucket burst size
    retry_after_ms: Optional[torch.Tensor]  # () client-visible Retry-After


def no_dynamics() -> ProviderDynamics:
    """The stationary provider: every mechanism off."""
    return ProviderDynamics(None, None, None, None)


def brownout_schedule(n_ticks: int, dt_ms: float, windows, span_ms: float
                      ) -> torch.Tensor:
    """(T,) float32 comfort multiplier: 1 except inside each `(start_frac,
    end_frac, scale)` window, fractions of the scenario's arrival span
    `span_ms`; overlapping windows take the least scale.  A tick is
    inside a window by its end time, (t + 1) * dt."""
    t_ms = (torch.arange(n_ticks, dtype=torch.float32) + 1.0) * dt_ms
    scale = torch.ones((n_ticks,), dtype=torch.float32)
    for start_frac, end_frac, s in windows:
        inside = (t_ms >= start_frac * span_ms) & (t_ms < end_frac * span_ms)
        scale = torch.where(
            inside,
            torch.minimum(scale, torch.tensor(s, dtype=torch.float32)),
            scale)
    return scale


def token_bucket_schedule(n_ticks: int, dt_ms: float, rate_rps, burst: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, K) grants refilled a tick and (K,) burst capacity of a limiter
    of `rate_rps[k]` sustained grants a second, constant over time."""
    rate = torch.tensor(rate_rps, dtype=torch.float32)
    refill = (rate * (dt_ms / 1000.0)).expand(n_ticks, rate.shape[0])
    capacity = torch.full((rate.shape[0],), burst, dtype=torch.float32)
    return refill, capacity


def token_bucket_windows(n_ticks: int, dt_ms: float, rate_rps, burst: float,
                         windows, span_ms: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-varying refill: the constant schedule scaled by `(start_frac,
    end_frac, rate_mult)` windows over `span_ms` (overlaps take the
    least multiplier; 0 freezes the refill).  Capacity is not
    rescaled."""
    for _, _, m in windows:
        if m < 0:
            raise ValueError(f"rate_mult must be >= 0, got {m}")
    refill, capacity = token_bucket_schedule(n_ticks, dt_ms, rate_rps, burst)
    # the brownout's windowed minimum, over rate multipliers
    scale = brownout_schedule(n_ticks, dt_ms, windows, span_ms)
    return refill * scale[:, None], capacity


# ---------------------------------------------------------------------------
# Fleet: a (P,) provider axis
# ---------------------------------------------------------------------------

class FleetPhysics(NamedTuple):
    """`ProviderPhysics` stacked along a (P,) endpoint axis.  The physics
    formulas are elementwise, so `service_time_ms` works unchanged on a
    per-grant gather of these leaves."""

    base_ms: torch.Tensor              # (P,) float32
    ms_per_token: torch.Tensor         # (P,) float32
    comfort_concurrency: torch.Tensor  # (P,) float32
    slowdown_slope: torch.Tensor       # (P,) float32
    slowdown_quad: torch.Tensor        # (P,) float32


class FleetDynamics(NamedTuple):
    """Per-tick, per-endpoint schedules.  None fields are mechanisms
    that are off; `retry_after_ms` is always present (both the limiter's
    bounce and the failover requeue wait it out)."""

    avail: Optional[torch.Tensor]          # (T, P) 0/1 endpoint up
    comfort_scale: Optional[torch.Tensor]  # (T, P) brownout multiplier
    tb_refill: Optional[torch.Tensor]      # (T, P, K) grants a tick
    tb_capacity: Optional[torch.Tensor]    # (P, K) bucket burst size
    retry_after_ms: torch.Tensor           # () client-visible Retry-After


class Fleet(NamedTuple):
    """What `run_sim(..., fleet=...)` takes."""

    phys: FleetPhysics
    dyn: FleetDynamics


def uniform_fleet_physics(phys: ProviderPhysics, p: int, speed_mult=None,
                          comfort_mult=None) -> FleetPhysics:
    """One endpoint's physics broadcast over P; `speed_mult[p]` scales
    the per-token cost (< 1 is faster), `comfort_mult[p]` the knee."""
    dev = phys.base_ms.device
    ones = torch.ones((p,), dtype=torch.float32, device=dev)
    speed = ones if speed_mult is None else torch.as_tensor(
        speed_mult, dtype=torch.float32, device=dev)
    comfort = ones if comfort_mult is None else torch.as_tensor(
        comfort_mult, dtype=torch.float32, device=dev)
    return FleetPhysics(
        base_ms=phys.base_ms.expand(p).clone(),
        ms_per_token=phys.ms_per_token * speed,
        comfort_concurrency=phys.comfort_concurrency * comfort,
        slowdown_slope=phys.slowdown_slope.expand(p).clone(),
        slowdown_quad=phys.slowdown_quad.expand(p).clone(),
    )


def _tick_end_ms(n_ticks: int, dt_ms: float) -> torch.Tensor:
    return (torch.arange(n_ticks, dtype=torch.float32) + 1.0) * dt_ms


def availability_schedule(n_ticks: int, dt_ms: float, fail_windows,
                          span_ms: float, p: int) -> torch.Tensor:
    """(T, P) float32 availability: 1 except inside each `(endpoint,
    start_frac, end_frac)` fail window over the arrival span."""
    t_ms = _tick_end_ms(n_ticks, dt_ms)
    avail = torch.ones((n_ticks, p), dtype=torch.float32)
    for ep, start_frac, end_frac in fail_windows:
        inside = (t_ms >= start_frac * span_ms) & (t_ms < end_frac * span_ms)
        avail[:, ep] = torch.where(inside, 0.0, avail[:, ep])
    return avail


def fleet_brownout_schedule(n_ticks: int, dt_ms: float, windows,
                            span_ms: float, p: int) -> torch.Tensor:
    """(T, P) float32 comfort multiplier: `brownout_schedule` per
    endpoint, from `(endpoint, start_frac, end_frac, scale)` windows;
    overlaps on one endpoint take the least scale."""
    t_ms = _tick_end_ms(n_ticks, dt_ms)
    scale = torch.ones((n_ticks, p), dtype=torch.float32)
    for ep, start_frac, end_frac, s in windows:
        inside = (t_ms >= start_frac * span_ms) & (t_ms < end_frac * span_ms)
        scale[:, ep] = torch.where(
            inside,
            torch.minimum(scale[:, ep], torch.tensor(s, dtype=torch.float32)),
            scale[:, ep])
    return scale
