"""FaultSchedule: the contract-breaking provider, as a static spec.

Counterpart of `repro.sim.faults`, a copy of that numpy-only module (the
port imports nothing of the reference).  A provider is honest by
default: completions arrive exactly once, Retry-After hints are
truthful, nothing gets stuck.  A `FaultSchedule` is a hashable set of
scalar knobs for four fault families:

  * silent drops: `drop_frac` of landed completions never delivered;
  * stuck requests: service time inflated by `stuck_mult`;
  * duplicate completions: the same ticket delivered `1 + dup_extra`
    times, each copy `dup_delay_ms` later, its finish stamp skewed by
    `dup_jitter_ms` a copy;
  * lying Retry-After: 429 hints scaled by `retry_lie_mult`.

Draws are keyed per ticket (per attempt), so a resubmitted request gets
fresh draws.  `FaultSchedule()` injects nothing.  The scenario registry
(`sim/scenarios.py`) names schedules; only a live provider injects them
(ROADMAP queue A, item A6), the simulator's transport stays honest.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FaultSchedule(NamedTuple):
    """Static fault spec (all scalars — hashable, usable inside a
    `Scenario`).  The default instance injects nothing."""

    seed: int = 0
    # silent drops: fraction of landed completions never delivered
    drop_frac: float = 0.0
    # stuck requests: fraction of accepted submits whose service time is
    # inflated by `stuck_mult`
    stuck_frac: float = 0.0
    stuck_mult: float = 40.0
    # duplicate completions: fraction of delivered completions redelivered
    # `dup_extra` more times, each copy `dup_delay_ms` later than the
    # last with a payload finish stamp skewed by `dup_jitter_ms` per copy
    dup_frac: float = 0.0
    dup_extra: int = 1
    dup_delay_ms: float = 100.0
    dup_jitter_ms: float = 0.0
    # lying Retry-After: multiplier on the hint a 429 bounce carries;
    # 1.0 is honest, < 1 understates the refill (clients retry too early
    # and re-bounce), > 1 overstates it (clients idle past recovery)
    retry_lie_mult: float = 1.0

    @property
    def injects(self) -> bool:
        """Whether any fault family is active (an all-default schedule
        is equivalent to `faults=None` up to dead draws)."""
        return (self.drop_frac > 0.0 or self.stuck_frac > 0.0
                or self.dup_frac > 0.0 or self.retry_lie_mult != 1.0)


class FaultDraw(NamedTuple):
    """Per-ticket fault verdicts, deterministic in
    (schedule.seed, salt, ticket)."""

    drop: bool
    stuck: bool
    dup: bool


def fault_draw(fs: FaultSchedule, salt: int, ticket: int) -> FaultDraw:
    """Draw the per-attempt fault verdicts for one ticket.

    Keyed by (seed, salt, ticket) through a `SeedSequence`, so replays
    are deterministic across platforms and independent of draw order —
    the provider may evaluate tickets in any sequence and a resubmitted
    request (fresh ticket) gets independent draws.
    """
    u = np.random.default_rng(
        np.random.SeedSequence((fs.seed, salt, ticket))).random(3)
    return FaultDraw(
        drop=bool(u[0] < fs.drop_frac),
        stuck=bool(u[1] < fs.stuck_frac),
        dup=bool(u[2] < fs.dup_frac),
    )
