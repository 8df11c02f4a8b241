"""FleetProvider: P async endpoints behind one `AsyncProvider` face.

Counterpart of `repro.client.fleet`: the live-path sibling of the
engine's fleet mode.  A session schedules against ONE provider
boundary, and this adapter multiplexes it over P child
`AsyncProvider`s with the routing cost model of
`core.routing.route_requests`,

    cost[p] = (base_ms[p] + ms_per_token[p] * p50) * (1 + out[p]/comfort[p])
              + 429_pressure[p]            (UNAVAIL_MS if p is down)

evaluated per submit on the client-observable signals only: each
child's outstanding count and the Retry-After bounces the adapter has
seen.  A client cannot see the provider's buckets, only its bounces, so
an endpoint that recently 429'd carries its (sanitized) Retry-After as
a routing penalty until that backoff expires.

The cost is host numpy in float32, one rounding per operation in the
order written above, as the reference evaluates it.  It does not use
`numerics.fma32`: that models the contractions of the engine's compiled
`route_requests` (ROADMAP queue C, C7), not this adapter.

Failure semantics differ from the engine's by design.  The engine
models abrupt endpoint death: in-flight work is killed and requeued.
This adapter drains gracefully: a down endpoint refuses new submits
(UNAVAIL cost; if the whole fleet is down the submit bounces 429-style
with `retry_after_ms`), but its accepted work still completes through
`poll`.

With P == 1 the adapter is a pass-through: the argmin has one
candidate and `inflight_hint` is forwarded to the child untouched, so a
single-endpoint fleet replays the bare child's session bit for bit.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from repro_torch.client.provider import (
    AsyncProvider,
    Completion,
    SubmitResult,
    sanitize_retry_after_ms,
)
from repro_torch.core.routing import UNAVAIL_MS
from repro_torch.sim.provider import FleetPhysics, ProviderPhysics

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.client.request import Request


def _np(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class FleetProvider:
    """Route every submit to the cheapest of P child endpoints.

    `providers` are the child transports (any `AsyncProvider`); `fphys`
    carries the (P,)-leaf speed and comfort estimates the routing cost
    reads (the client's model of the endpoints, tensors or arrays).
    `avail` is an optional (T, P) availability schedule sampled at
    `dt_ms` ticks: the replay hook for failover.
    """

    def __init__(
        self,
        providers: Sequence[AsyncProvider],
        fphys: FleetPhysics,
        *,
        dt_ms: float = 25.0,
        avail: Optional[np.ndarray] = None,   # (T, P) rows, like engine xs
        retry_after_ms: float = 1500.0,
    ):
        if len(providers) == 0:
            raise ValueError("FleetProvider needs at least one endpoint")
        p = len(providers)
        base = _np(fphys.base_ms)
        if base.shape != (p,):
            raise ValueError(f"fphys is {base.shape[0]}-endpoint but {p} "
                             f"providers were given")
        self.providers = list(providers)
        self.p = p
        self._base = base.astype(np.float32)
        self._ms_per_token = _np(fphys.ms_per_token).astype(np.float32)
        self._comfort = _np(fphys.comfort_concurrency).astype(np.float32)
        self.dt_ms = float(dt_ms)
        self._avail_rows = (None if avail is None
                            else _np(avail).astype(np.float32))
        self.retry_after_ms = float(retry_after_ms)
        # fleet ticket -> (endpoint, child ticket); fleet tickets are
        # monotone, so completions report in a stable, mergeable order
        self._tickets: dict[int, tuple[int, int]] = {}
        self._by_child: list[dict[int, int]] = [dict() for _ in range(p)]
        self._next_ticket = 0
        # observed 429 pressure: endpoint p is penalized by its last
        # Retry-After until that backoff expires
        self._dry_until = np.zeros((p,), np.float64)
        self._dry_penalty = np.zeros((p,), np.float32)
        self.n_routed = np.zeros((p,), np.int64)
        self.n_refused = 0

    @classmethod
    def from_fleet_scenario(cls, scenario, n_requests: int, n_ticks: int,
                            dt_ms: float, k: int,
                            phys: ProviderPhysics | None = None,
                            arrival_scale: float = 1.0) -> "FleetProvider":
        """The live fleet of a registry fleet scenario: one `MockProvider`
        per endpoint with that endpoint's physics, brownout column and
        bucket schedule (the arrays `scenarios.build_fleet` hands the
        engine), each with the scenario's faults on a stream of its own,
        and the (T, P) availability schedule on the adapter.
        `arrival_scale` compresses the schedules with the arrivals, as
        `build_fleet(..., arrival_scale)` does."""
        from repro_torch.client.provider import MockProvider
        from repro_torch.sim.provider import default_physics
        from repro_torch.sim.scenarios import build_fleet

        phys = phys if phys is not None else default_physics()
        fleet = build_fleet(scenario, phys, n_ticks, dt_ms, n_requests, k,
                            arrival_scale)
        if fleet is None:
            raise ValueError(
                f"scenario {scenario.name!r} carries no fleet spec")
        fphys, dyn = fleet.phys, fleet.dyn
        retry = float(dyn.retry_after_ms)

        def column(x, ep):
            return None if x is None else _np(x[:, ep])

        children = [
            MockProvider(
                ProviderPhysics(*(a[ep] for a in fphys)),
                dt_ms=dt_ms,
                comfort_scale=column(dyn.comfort_scale, ep),
                tb_refill=column(dyn.tb_refill, ep),
                tb_capacity=(None if dyn.tb_capacity is None
                             else _np(dyn.tb_capacity[ep])),
                retry_after_ms=retry,
                # each endpoint misbehaves on its own: the same schedule,
                # a decorrelated draw stream
                faults=scenario.faults,
                fault_salt=ep,
            )
            for ep in range(fphys.base_ms.shape[0])
        ]
        return cls(children, fphys, dt_ms=dt_ms, avail=dyn.avail,
                   retry_after_ms=retry)

    # --- routing ------------------------------------------------------
    def _avail_row(self, now_ms: float) -> Optional[np.ndarray]:
        if self._avail_rows is None:
            return None
        t = int(np.floor(now_ms / self.dt_ms + 1e-6)) - 1
        t = min(max(t, 0), self._avail_rows.shape[0] - 1)
        return self._avail_rows[t]

    def route(self, p50: float, now_ms: float) -> tuple[int, float]:
        """(endpoint, cost in seconds) for a request of predicted size
        `p50`.  A tie goes to the lowest endpoint (np.argmin)."""
        out = np.asarray(
            [float(c.inflight()) for c in self.providers], np.float32)
        load = out / np.maximum(self._comfort, np.float32(1.0))
        unloaded = self._base + self._ms_per_token * np.float32(p50)
        cost = unloaded * (np.float32(1.0) + load)
        dry = now_ms < self._dry_until
        cost = cost + np.where(dry, self._dry_penalty, np.float32(0.0))
        row = self._avail_row(now_ms)
        if row is not None:
            cost = np.where(row < 0.5, np.float32(UNAVAIL_MS), cost)
        ep = int(np.argmin(cost))
        return ep, float(cost[ep]) * 1e-3

    # --- AsyncProvider ------------------------------------------------
    def submit(self, req: "Request", now_ms: float,
               inflight_hint: int | None = None) -> SubmitResult:
        ep, cost_s = self.route(req.p50, now_ms)
        if cost_s * 1e3 >= UNAVAIL_MS:
            # the whole fleet is down: bounce like a 429 so the session's
            # retry machinery handles the outage
            self.n_refused += 1
            return SubmitResult(False, self.retry_after_ms)
        # P == 1 forwards the session's concurrency view, so the fleet
        # prices service as the bare child does; P > 1 lets each child
        # price at its own outstanding count
        hint = inflight_hint if self.p == 1 else None
        res = self.providers[ep].submit(req, now_ms, inflight_hint=hint)
        if not res.accepted:
            # a hostile hint (negative, NaN) is sanitized before it
            # becomes a penalty: it would poison the argmin or reward the
            # dry endpoint; the raw hint still goes to the session
            hint_ms = sanitize_retry_after_ms(res.retry_after_ms)
            self._dry_until[ep] = now_ms + hint_ms
            self._dry_penalty[ep] = np.float32(hint_ms)
            return res
        ticket = self._next_ticket
        self._next_ticket += 1
        self._tickets[ticket] = (ep, res.ticket)
        self._by_child[ep][res.ticket] = ticket
        self.n_routed[ep] += 1
        return SubmitResult(True, 0.0, ticket=ticket)

    def poll(self, now_ms: float) -> list[Completion]:
        out = []
        for ep, child in enumerate(self.providers):
            for c in child.poll(now_ms):
                ticket = self._by_child[ep].pop(c.ticket)
                del self._tickets[ticket]
                out.append(Completion(ticket, c.finish_ms, c.output))
        # fleet-ticket order, whichever child reported first
        out.sort(key=lambda c: c.ticket)
        return out

    def inflight(self) -> int:
        return sum(c.inflight() for c in self.providers)

    def inflight_by_endpoint(self) -> np.ndarray:
        """(P,) outstanding counts: the routing layer's load signal."""
        return np.asarray([c.inflight() for c in self.providers], np.int64)

    def next_event_ms(self, now_ms: float) -> Optional[float]:
        cands = []
        for c in self.providers:
            e = c.next_event_ms(now_ms)
            if e is not None:
                cands.append(float(e))
        return min(cands) if cands else None
