"""Client-facing request record for the streaming session API.

Counterpart of `repro.client.request`, host-side as there.  One
`Request` is one unit of work a user hands to `ClientSession.submit`.
It carries what the paper's client-side stack may see at the black-box
boundary: the payload, the coarse priors (p50/p90), the bucket/class
tags the policy routes on, and the lifecycle fields the session fills
in as the request moves through admit/defer/429/complete.

When the caller has no tail prior, `default_p90` derives one from the
workload generator's per-bucket token distribution (log-uniform within
the bucket, so p90/p50 = (hi/lo)^0.4, `sim.workload.P90_OVER_P50`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.sim.workload import P90_OVER_P50_NP


def default_p90(p50: float, bucket: int) -> float:
    """Tail prior implied by the bucket's realized token distribution:
    p90/p50 = (hi/lo)^0.4 for tokens log-uniform in [lo, hi]."""
    return float(p50) * float(P90_OVER_P50_NP[int(bucket)])


@dataclasses.dataclass
class Request:
    """One client request.  Caller-provided fields first; the session
    owns the lifecycle fields below the fold."""

    rid: int                    # caller-scoped id (session reassigns its own)
    prompt: Optional[np.ndarray]  # (S_p,) int32 payload; None for mock runs
    max_new: float              # realized/requested output tokens (true cost)
    p50: float                  # coarse prior available at submission
    bucket: int                 # token bucket in [0, 4)
    p90: Optional[float] = None  # tail prior; None = default_p90(p50, bucket)
    cls: Optional[int] = None   # service class; None = paper 2-lane bucket
                                # split (K-class policies expect the caller
                                # to tag tenant/lane ids)
    arrival_s: float = 0.0      # arrival time (session clock, seconds)
    jitter: float = 1.0         # provider-side noise multiplier (the mock
                                # provider applies it; replays pass the
                                # workload generator's jitter stream)

    # --- lifecycle (session-owned) ------------------------------------
    submit_s: float = 0.0       # time handed to the provider
    finish_s: float = 0.0       # provider completion time
    status: str = "pending"     # pending|inflight|completed|rejected|abandoned
    n_defers: int = 0
    n_throttles: int = 0        # 429-style bounces this request saw
    n_resubmits: int = 0        # watchdog resubmissions (resilience layer)
    output: Optional[np.ndarray] = None

    def resolved_p90(self) -> float:
        return self.p90 if self.p90 is not None else default_p90(
            self.p50, self.bucket)

    def resolved_cls(self) -> int:
        """Service class with the paper's 2-lane default (interactive =
        short bucket, heavy = everything else), the one definition the
        session's window staging and the providers' token-bucket class
        routing both use (as `sim.workload`'s `paper2` class map)."""
        return int(self.cls) if self.cls is not None else int(self.bucket != 0)
