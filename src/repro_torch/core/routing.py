"""Layer 0 — fleet routing: endpoint choice above allocation.

Counterpart of `repro.core.routing`.  With a (P,) provider axis every
release carries two decisions: which request (the three paper layers,
unchanged) and which endpoint (this module).  The cost of sending
request r to endpoint p is a predicted completion time,

    cost[p, r] = unloaded(p, r) * (1 + inflight[p] / comfort[p])
                 + 429_pressure[p]          (UNAVAIL_MS if p is down)

with `unloaded(p, r) = base_ms[p] + ms_per_token[p] * p50[r]` and the
429 pressure the Retry-After scaled by the share of the endpoint's
class buckets holding less than one grant.  `route_requests` returns
each request's cheapest endpoint and that cost in seconds, the route
term the ordering layer subtracts from scored classes.

Rounding: the reference's compiled program contracts both steps of the
cost into FMAs, `fma(ms_per_token, p50, base_ms)` and
`fma(unloaded, 1 + load, penalty)`, although their inputs pass through
its optimization barrier (ROADMAP queue C, C1's pattern).  The port
rounds each of the two once with `numerics.fma32`, which gives the same
bits on the CPU and on CUDA.  The argmin is a loop over the P endpoints
with a strict `<`, so a tie goes to the lowest endpoint on every device.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import fma32, pinned
from repro_torch.core.types import FleetState

# Finite "effectively never" cost of a down endpoint: it dominates any
# real predicted delay, yet keeps the route term finite when the whole
# fleet is down.
UNAVAIL_MS = 1e9


def route_requests(fphys, fleet: FleetState, p50: torch.Tensor,
                   comfort_t=None, avail_t=None, retry_after_ms=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every (endpoint, request) pair; pick each request's endpoint.

    fphys: `FleetPhysics` with (P,) leaves; fleet: the current
    `FleetState`; p50: (N,) float32 predicted sizes (the dense batch or a
    window view); comfort_t: (P,) brownout row or None; avail_t: (P,)
    availability row or None; retry_after_ms: () float32 when a limiter
    is configured (it turns on the 429 pressure).

    Returns (endpoint (N,) int32, route (N,) float32): the cheapest
    endpoint of each request (ties to the lowest) and its cost in
    seconds."""
    comfort = fphys.comfort_concurrency
    if comfort_t is not None:
        comfort = comfort * comfort_t
    # the integer outstanding count over comfort: a congestion estimate
    # that does not depend on the width the engine reduces at
    load = fleet.inflight.float() / torch.clamp(comfort, min=1.0)
    penalty = torch.zeros_like(load)
    if retry_after_ms is not None:
        dry = (fleet.tb_tokens < 1.0).float().mean(dim=1)
        penalty = retry_after_ms * dry
    base, mpt, loadv, pen = pinned(
        (fphys.base_ms, fphys.ms_per_token, load, penalty))
    unloaded = fma32(mpt[:, None], p50[None, :], base[:, None])   # (P, N)
    cost = fma32(unloaded, (1.0 + loadv)[:, None], pen[:, None])
    if avail_t is not None:
        cost = torch.where(avail_t[:, None] < 0.5, UNAVAIL_MS, cost)
    best = cost[0]
    endpoint = torch.zeros(p50.shape, dtype=torch.int32, device=p50.device)
    for p in range(1, cost.shape[0]):
        better = cost[p] < best
        best = torch.where(better, cost[p], best)
        endpoint = torch.where(better, p, endpoint).to(torch.int32)
    route = pinned(best * 1e-3)
    return endpoint, route
