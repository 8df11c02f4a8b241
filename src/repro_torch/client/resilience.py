"""Client-side resilience: the watchdog that survives a lying provider.

Counterpart of `repro.client.resilience`, pure host bookkeeping as
there.  `ClientSession` trusts the transport by default: an accepted
submit is assumed to produce exactly one completion.  Against a provider
that breaks that contract (`sim/faults.py`: silent drops, stuck
requests, duplicate deliveries, lying Retry-After) trust means a hung
session, since an INFLIGHT slot retires only when its completion lands.

The recovery design (wired into `ClientSession.poll` when the session is
built with a `ResilienceConfig`):

  * **Client-side deadline.**  Every accepted attempt gets a deadline
    from client-observable priors only: the unloaded latency at the p90
    token prior (`base_ms + ms_per_token * p90`) times `timeout_mult`,
    floored at `min_deadline_ms`.
  * **Bounded-budget resubmission.**  An attempt past its deadline is
    resubmitted (same request, same session rid, a fresh provider
    ticket) at most `max_resubmits` times.  The old ticket stays mapped:
    attempts race, the first completion wins, the loser is discarded by
    the session's duplicate-safe ingestion.  Each accepted resubmit
    charges the request's p50 against its class's ADRR deficit
    (`core.scheduler.charge_resubmit`).  A 429 on the resubmit consumes
    no budget; the watchdog backs off by the (sanitized) hint.
  * **Give-up.**  With the budget spent, the watchdog waits for the
    slot's own timeout threshold and then injects a synthetic completion
    stamped `finish = now`, which the ordinary retirement chain (device
    and host mirror alike) classifies timed out and retires ABANDONED.

The watchdog never touches device state: it edits the host-side
completion dict before the scatter, submits through the same provider
boundary as the grant loop, and reports its deficit charge as one (K,)
array folded into the fused tick.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

from repro_torch.sim.provider import ProviderPhysics

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.client.request import Request


class ResilienceConfig(NamedTuple):
    """Static watchdog knobs (`None` on the session = off)."""

    # client-side deadline = unloaded p90 latency x timeout_mult,
    # floored at min_deadline_ms
    timeout_mult: float = 6.0
    min_deadline_ms: float = 1_000.0
    # resubmission budget per request (attempts beyond the first)
    max_resubmits: int = 2


class _Tracked:
    """Watchdog entry for one in-flight session rid."""

    __slots__ = ("tickets", "deadline_ms", "n_resubmits", "gave_up")

    def __init__(self, ticket: int, deadline_ms: float):
        self.tickets = [ticket]      # every live provider ticket (racing)
        self.deadline_ms = deadline_ms
        self.n_resubmits = 0
        self.gave_up = False


class Watchdog:
    """Per-request deadline tracking and resubmission budget accounting.

    Owns no clock and no provider: `ClientSession.poll` drives it once
    an epoch and performs the submits."""

    def __init__(self, cfg: ResilienceConfig, phys: ProviderPhysics):
        self.cfg = cfg
        self._base = float(phys.base_ms)
        self._ms_per_token = float(phys.ms_per_token)
        self._by_rid: dict[int, _Tracked] = {}
        self.n_resubmits = 0
        self.n_gave_up = 0

    def deadline_ms(self, req: "Request") -> float:
        """Relative client-side deadline for one attempt of `req`."""
        unloaded = self._base + self._ms_per_token * float(req.resolved_p90())
        return max(unloaded * self.cfg.timeout_mult, self.cfg.min_deadline_ms)

    # --- lifecycle driven by the session ------------------------------
    def note_admit(self, rid: int, req: "Request", ticket: int,
                   now_ms: float) -> None:
        """An initial submit was accepted: start the deadline clock."""
        self._by_rid[rid] = _Tracked(ticket, now_ms + self.deadline_ms(req))

    def note_resubmit(self, rid: int, req: "Request", ticket: int,
                      now_ms: float) -> None:
        """A resubmit was accepted: consume budget, reset the deadline."""
        e = self._by_rid[rid]
        e.tickets.append(ticket)
        e.n_resubmits += 1
        e.deadline_ms = now_ms + self.deadline_ms(req)
        self.n_resubmits += 1

    def note_bounced(self, rid: int, delay_ms: float, now_ms: float) -> None:
        """A resubmit was 429'd: no budget consumed, re-check after the
        (already sanitized) backoff."""
        self._by_rid[rid].deadline_ms = now_ms + max(delay_ms, 1.0)

    def note_terminal(self, rid: int) -> list[int]:
        """The rid retired: stop tracking it and return every ticket the
        session must unmap (late arrivals on them are discarded)."""
        e = self._by_rid.pop(rid, None)
        return e.tickets if e is not None else []

    # --- the per-epoch scan -------------------------------------------
    def overdue(self, now_ms: float) -> list[int]:
        """Tracked rids past their deadline, in rid order."""
        return sorted(
            rid for rid, e in self._by_rid.items()
            if not e.gave_up and now_ms >= e.deadline_ms)

    def budget_left(self, rid: int) -> bool:
        return self._by_rid[rid].n_resubmits < self.cfg.max_resubmits

    def give_up(self, rid: int) -> None:
        e = self._by_rid[rid]
        if not e.gave_up:
            e.gave_up = True
            self.n_gave_up += 1

    def next_deadline_ms(self) -> float:
        """Earliest pending watchdog deadline (idle-sleep hint)."""
        return min(
            (e.deadline_ms for e in self._by_rid.values() if not e.gave_up),
            default=float("inf"))
