"""Struct-of-tensor types for the client-side scheduling stack.

Counterpart of `repro.core.types`: the same NamedTuples and field
names, holding torch tensors instead of jax arrays.  Request status
codes follow the paper's lifecycle:

    PENDING --admit--> INFLIGHT --complete--> COMPLETED
            --defer--> (PENDING with defer_until in the future)
            --reject--> REJECTED
            --timeout--> ABANDONED

Stored indices stay int32; code casts to int64 only where it indexes.
Fleet state (`FleetState`, `RequestState.endpoint`, `SimState.fleet`)
is present only in fleet mode: None marks the mechanism's absence, so a
single-provider run carries exactly the single-provider state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Request status codes
PENDING = 0
INFLIGHT = 1
COMPLETED = 2
REJECTED = 3
ABANDONED = 4

# Bucket ids (paper: short <=64, medium 65-256, long 257-1024, xlong >1024)
SHORT, MEDIUM, LONG, XLONG = 0, 1, 2, 3
N_BUCKETS = 4

# Service classes: the paper's two lanes are the default K = 2
CLS_INTERACTIVE = 0
CLS_HEAVY = 1
N_CLASSES = 2

NEVER = float("inf")  # threshold value meaning "this action never fires"


class RequestBatch(NamedTuple):
    """Static per-request fields of one workload instance (capacity N)."""

    arrival_ms: torch.Tensor          # (N,) float32 absolute arrival time
    bucket: torch.Tensor              # (N,) int32 in [0, 4)
    cls: torch.Tensor                 # (N,) int32 service class in [0, K)
    true_tokens: torch.Tensor         # (N,) float32 realized output tokens
    p50: torch.Tensor                 # (N,) float32 policy-facing prior
    p90: torch.Tensor                 # (N,) float32 policy-facing tail prior
    deadline_budget_ms: torch.Tensor  # (N,) float32 relative SLO budget
    valid: torch.Tensor               # (N,) bool padding mask

    @property
    def n(self) -> int:
        return self.arrival_ms.shape[0]


class RequestState(NamedTuple):
    """Per-request lifecycle state (simulator-owned)."""

    status: torch.Tensor       # (N,) int32 status code
    submit_ms: torch.Tensor    # (N,) float32 time handed to the provider
    finish_ms: torch.Tensor    # (N,) float32 provider completion time
    defer_until: torch.Tensor  # (N,) float32 earliest re-eligibility
    n_defers: torch.Tensor     # (N,) int32 times this request was deferred
    n_throttles: torch.Tensor  # (N,) int32 provider 429s this request saw
    # (N,) int32 fleet endpoint the request was last routed to; None
    # outside fleet mode
    endpoint: Optional[torch.Tensor] = None


class SchedState(NamedTuple):
    """Scheduler-internal state (allocation layer + overload signals)."""

    deficit: torch.Tensor            # (K,) float32 DRR deficit counters
    rr_turn: torch.Tensor            # () int32 round-robin pointer
    ema_latency_ratio: torch.Tensor  # () float32 observed/expected EMA
    n_completed_obs: torch.Tensor    # () int32 completions observed


class ProviderState(NamedTuple):
    """Client-visible aggregate view of the black box."""

    inflight: torch.Tensor         # () int32 outstanding requests
    inflight_tokens: torch.Tensor  # () float32 outstanding predicted work
    tb_tokens: torch.Tensor        # (K,) float32 rate-limit grants left
    n_throttled: torch.Tensor      # () int32 total 429-style bounces


class FleetState(NamedTuple):
    """Per-endpoint provider state along the fleet axis P.  In fleet
    mode `ProviderState` keeps the global totals (allocation and
    overload are endpoint-agnostic); this carries the per-endpoint
    split the routing layer scores."""

    inflight: torch.Tensor         # (P,) int32 outstanding per endpoint
    inflight_tokens: torch.Tensor  # (P,) float32 outstanding predicted work
    tb_tokens: torch.Tensor        # (P, K) float32 per-endpoint rate grants
    n_throttled: torch.Tensor      # (P,) int32 429 bounces per endpoint
    n_requeued: torch.Tensor       # (P,) int32 in-flight requests requeued
                                   #   by an endpoint failure (failover)


class SimState(NamedTuple):
    now_ms: torch.Tensor  # () float32
    req: RequestState
    sched: SchedState
    provider: ProviderState
    fleet: Optional[FleetState] = None  # (P,) split; None = one provider


class WindowCarry(NamedTuple):
    """Compacted active-window slot pool (reference DESIGN.md §6).

    Occupied slots are the prefix `[0, n_live)`, sorted by request id
    (arrivals are admitted in id order and compaction is stable), so
    first-occurrence tie-breaking over the window equals the dense
    path's.  `slot_req[i] == n` marks slot i empty.
    """

    slot_req: torch.Tensor  # (W,) int32 request id per slot; n = empty
    arr_ptr: torch.Tensor   # () int32 arrivals admitted so far
    n_live: torch.Tensor    # () int32 occupied slot count


def take(x: torch.Tensor | None, idx: torch.Tensor) -> torch.Tensor | None:
    """`x[idx]` for a 1-d `x` and an integer tensor `idx` of any shape,
    cast to int64 here, at the indexing site.  Unlike `x[idx]` with a
    0-d tensor, it never reads the index back to the host.  A None `x`
    (a mechanism that is off) stays None."""
    if x is None:
        return None
    return torch.take(x, idx if idx.dtype == torch.int64 else idx.long())


def init_request_state(n: int, device: torch.device) -> RequestState:
    f32, i32 = torch.float32, torch.int32
    return RequestState(
        status=torch.zeros((n,), dtype=i32, device=device),
        submit_ms=torch.full((n,), float("inf"), dtype=f32, device=device),
        finish_ms=torch.full((n,), float("inf"), dtype=f32, device=device),
        defer_until=torch.zeros((n,), dtype=f32, device=device),
        n_defers=torch.zeros((n,), dtype=i32, device=device),
        n_throttles=torch.zeros((n,), dtype=i32, device=device),
    )


def init_sched_state(n_classes: int, device: torch.device) -> SchedState:
    return SchedState(
        deficit=torch.zeros((n_classes,), dtype=torch.float32, device=device),
        rr_turn=torch.zeros((), dtype=torch.int32, device=device),
        ema_latency_ratio=torch.ones((), dtype=torch.float32, device=device),
        n_completed_obs=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_provider_state(n_classes: int, device: torch.device
                        ) -> ProviderState:
    return ProviderState(
        inflight=torch.zeros((), dtype=torch.int32, device=device),
        inflight_tokens=torch.zeros((), dtype=torch.float32, device=device),
        tb_tokens=torch.zeros((n_classes,), dtype=torch.float32,
                              device=device),
        n_throttled=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_fleet_state(p: int, n_classes: int, device: torch.device
                     ) -> FleetState:
    """Zeroed fleet state; `run_sim` fills the buckets to their burst
    capacity when a per-endpoint limiter is configured."""
    f32, i32 = torch.float32, torch.int32
    return FleetState(
        inflight=torch.zeros((p,), dtype=i32, device=device),
        inflight_tokens=torch.zeros((p,), dtype=f32, device=device),
        tb_tokens=torch.zeros((p, n_classes), dtype=f32, device=device),
        n_throttled=torch.zeros((p,), dtype=i32, device=device),
        n_requeued=torch.zeros((p,), dtype=i32, device=device),
    )


def empty_window_batch(w: int, device: torch.device) -> RequestBatch:
    """A (W,)-shaped all-empty batch view: the starting slot pool of a
    streaming `ClientSession` (`repro_torch.client.session`).  Empty
    slots are neutralized as the engine's `_window_view` neutralizes
    unoccupied slots: valid=False (never eligible); the other fields
    are don't-cares masked out of every decision path."""
    f32 = torch.float32
    return RequestBatch(
        arrival_ms=torch.zeros((w,), dtype=f32, device=device),
        bucket=torch.zeros((w,), dtype=torch.int32, device=device),
        cls=torch.zeros((w,), dtype=torch.int32, device=device),
        true_tokens=torch.ones((w,), dtype=f32, device=device),
        p50=torch.ones((w,), dtype=f32, device=device),
        p90=torch.ones((w,), dtype=f32, device=device),
        deadline_budget_ms=torch.full((w,), 1e9, dtype=f32, device=device),
        valid=torch.zeros((w,), dtype=torch.bool, device=device),
    )


def empty_window_request_state(w: int, device: torch.device
                               ) -> RequestState:
    """Matching (W,)-shaped request state for `empty_window_batch`:
    empty slots are terminal (REJECTED, as the engine view's sentinel)
    and never land (finish=inf), so retirement, eligibility and the
    inflight recount never see them."""
    f32, i32 = torch.float32, torch.int32
    return RequestState(
        status=torch.full((w,), REJECTED, dtype=i32, device=device),
        submit_ms=torch.full((w,), float("inf"), dtype=f32, device=device),
        finish_ms=torch.full((w,), float("inf"), dtype=f32, device=device),
        defer_until=torch.zeros((w,), dtype=f32, device=device),
        n_defers=torch.zeros((w,), dtype=i32, device=device),
        n_throttles=torch.zeros((w,), dtype=i32, device=device),
    )


def init_window_carry(w: int, n: int, device: torch.device) -> WindowCarry:
    return WindowCarry(
        slot_req=torch.full((w,), n, dtype=torch.int32, device=device),
        arr_ptr=torch.zeros((), dtype=torch.int32, device=device),
        n_live=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_sim_state(n: int, n_classes: int, device: torch.device) -> SimState:
    return SimState(
        now_ms=torch.zeros((), dtype=torch.float32, device=device),
        req=init_request_state(n, device),
        sched=init_sched_state(n_classes, device),
        provider=init_provider_state(n_classes, device),
    )
