"""`ClientSession`: the streaming client over an `AsyncProvider`.

Counterpart of `repro.client.session`.  The paper's scheduler sits at a
black-box API boundary, so the client is the product: requests arrive
over time (`submit`), the session makes batched admit/defer/reject
decisions (`poll`), and work flows through an `AsyncProvider` that may
429 it.  The session is open-ended and windowed:

  * **State is a compacted (W,) slot pool**, the live mirror of the
    windowed engine's `WindowCarry`: every live request (admitted to the
    window, not yet terminal) holds one slot, occupied slots form a
    request-id-sorted prefix, and a poll costs O(W + B) however many
    requests the session has seen.  Submissions beyond the window queue
    FIFO and are admitted as slots free.
  * **One device step a poll.**  The decision epoch (apply the previous
    epoch's verdicts, charge resubmits, ingest completions, retire,
    compact and admit, dispatch) is one call of `_fused_tick` on the
    session's device.  The pool never leaves the device: the host
    pushes one packed float32 vector a poll (the clock, the completion
    scatter, the staged arrivals, the previous verdicts, the resubmit
    charge; from pinned memory, without a host sync on CUDA) and pulls
    one packed `(4B+2,)` summary, the poll's only device-to-host sync.
    Terminal classification (completed vs abandoned) runs on host-side
    float32 mirrors that replay the device's comparison chains bit for
    bit, so no (W,) status pull is needed.
  * **Decisions come from the same `schedule_batch`** the simulator
    runs, on the same (K, W) view, through the ordering backend of
    `SessionConfig.backend` (`"kernel"`: `sched_score_topb`, K + 1
    launches a poll on the card); retirement is the engine's
    `_complete_and_timeout`.  Driven in virtual time over
    `MockProvider`, the session reproduces the windowed engine's
    decision sequence bit for bit.
  * **The provider boundary is async**: submits do not block, many
    requests ride in flight at once, and the session's concurrency
    count is the provider's outstanding count.  A 429 parks the request
    until `now + retry_after` through the `retry_policy` hook.
  * **Two clocks.**  `clock="virtual"` advances `dt_ms` a poll (or an
    explicit `now_ms`): deterministic replays, tests, benchmarks.
    `clock="wall"` reads the monotonic clock scaled by `time_scale`, and
    `drain()` sleeps until the next actionable instant instead of
    spinning.

Decision timing: `schedule_batch` runs at the end of epoch t's step, the
host submits the grants and collects the provider's verdicts, and the
state transition (`_apply_body`) is the first stage of epoch t+1's step:
the same floats in the same order as applying at the end of t, since
nothing in between reads the written fields, and one push a poll.
Reading `session._state` flushes the pending transition.

The reference donates its buffers and caches its compiled tick by
value; eager PyTorch has neither, so the port rebinds the pool's tensors
each poll and moves the policy and physics to the device once a session.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.client.provider import (
    AsyncProvider,
    Completion,
    expo_retry,  # noqa: F401  (re-exported, as in the reference)
    honor_retry_after,
    sanitize_retry_after_ms,
)
from repro_torch.client.request import Request
from repro_torch.client.resilience import ResilienceConfig, Watchdog
from repro_torch.core import overload as olc
from repro_torch.core.numerics import sum32
from repro_torch.core.ordering import BACKENDS
from repro_torch.core.policy import ALLOC_ADRR, PolicyConfig, n_classes
from repro_torch.core.scheduler import IDLE, charge_resubmit, schedule_batch
from repro_torch.core.types import (
    INFLIGHT,
    PENDING,
    REJECTED,
    RequestBatch,
    RequestState,
    SimState,
    empty_window_batch,
    empty_window_request_state,
    init_sim_state,
    take,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device, to_device
from repro_torch.sim.engine import _complete_and_timeout, _set_drop
from repro_torch.sim.provider import ProviderPhysics, default_physics
from repro_torch.sim.workload import DEADLINE_BUDGET_MS

_DEADLINE_PY = [float(x) for x in DEADLINE_BUDGET_MS.tolist()]
_EMPTY = np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# Configuration and result records
# ---------------------------------------------------------------------------


class SessionConfig(NamedTuple):
    window: int = 256          # slot-pool capacity W (a poll's cost is O(W))
    max_grants: int = 4        # batch dispatch width B a poll
    dt_ms: float = 25.0        # virtual tick / decision-epoch granularity
    backend: str = "kernel"    # ordering backend ("kernel" | "torch")
    time_scale: float = 1.0    # wall mode: session ms per wall ms
    max_idle_sleep_ms: float = 250.0  # wall mode: cap on one idle sleep
                                      # (session clock ms)


class PollResult(NamedTuple):
    """One decision epoch's outcome (all rids are session-scoped)."""

    now_ms: float
    actions: np.ndarray        # (B,) int32 decision per grant row
    req_rids: np.ndarray       # (B,) session rid per grant row (-1 = idle)
    severity: np.float32       # overload severity this epoch's ladder used
    completed: list[int]
    abandoned: list[int]
    rejected: list[int]
    admitted: list[int]
    deferred: list[int]
    throttled: list[int]       # 429-bounced this epoch
    n_live: int                # occupied window slots after admission
    progressed: bool           # anything moved (else the caller may sleep)


@dataclasses.dataclass
class SessionStats:
    n_polls: int = 0
    n_admitted: int = 0
    n_completed: int = 0
    n_rejected: int = 0
    n_abandoned: int = 0
    n_deferred: int = 0
    n_throttled: int = 0
    n_idle_sleeps: int = 0
    peak_inflight: int = 0
    # resilience / duplicate-safety accounting (zero on honest transports)
    n_resubmitted: int = 0      # watchdog resubmissions accepted
    n_gave_up: int = 0          # budget exhausted -> synthetic abandon
    n_dup_discarded: int = 0    # dead-ticket / same-epoch dup arrivals
    n_late_discarded: int = 0   # completions for already-retired rids


RetryPolicy = Callable[[float, int], float]


# ---------------------------------------------------------------------------
# The fused device tick
# ---------------------------------------------------------------------------

# rows of the packed (7, n_stage) staging push: int fields ride exactly
# in float32 (buckets and classes are tiny)
_ST_ARRIVAL, _ST_BUCKET, _ST_CLS, _ST_TOKENS = 0, 1, 2, 3
_ST_P50, _ST_P90, _ST_DEADLINE = 4, 5, 6


def _compact_and_admit(batch: RequestBatch, req: RequestState,
                       alive: torch.Tensor, staged, n_stage: int):
    """Stable-compact the live slots to the prefix (keeping request-id
    order, the ordering layer's tie-break invariant) and append the
    `n_stage` newly admitted requests (columns of `staged`, (7,
    n_stage)) behind them.  The slot map comes from a cumulative sum,
    as the engine's `_compact_and_admit`, with no host sync.  Staged
    request state is fresh (PENDING, finish=inf); vacated slots are
    neutralized as the engine's empty-slot view (invalid, REJECTED,
    finish=inf)."""
    w = alive.shape[0]
    iota = torch.arange(w, dtype=torch.int32, device=alive.device)
    pos = torch.cumsum(alive, 0, dtype=torch.int32) - 1
    src = _set_drop(torch.zeros_like(iota), pos, iota, alive).long()
    n_live = alive.sum(dtype=torch.int32)
    live_here = iota < n_live
    if n_stage:
        stage_here = (iota >= n_live) & (iota < n_live + n_stage)
        spos = torch.clamp(iota - n_live, 0, n_stage - 1).long()
        keep = live_here | stage_here
    else:
        stage_here, keep = None, live_here

    def mix(old, row=None, fresh=None, fill=None):
        v = old.index_select(0, src)
        if stage_here is not None:
            new = (staged[row].index_select(0, spos).to(old.dtype)
                   if row is not None else fresh)
            v = torch.where(stage_here, new, v)
        if fill is not None:
            v = torch.where(keep, v, fill)
        return v

    valid = live_here & batch.valid.index_select(0, src)
    if stage_here is not None:
        valid = valid | stage_here
    new_batch = RequestBatch(
        arrival_ms=mix(batch.arrival_ms, _ST_ARRIVAL),
        bucket=mix(batch.bucket, _ST_BUCKET),
        cls=mix(batch.cls, _ST_CLS),
        true_tokens=mix(batch.true_tokens, _ST_TOKENS),
        p50=mix(batch.p50, _ST_P50),
        p90=mix(batch.p90, _ST_P90),
        deadline_budget_ms=mix(batch.deadline_budget_ms, _ST_DEADLINE),
        valid=valid,
    )
    inf = float("inf")
    new_req = req._replace(
        status=mix(req.status, fresh=PENDING, fill=REJECTED),
        submit_ms=mix(req.submit_ms, fresh=inf),
        finish_ms=mix(req.finish_ms, fresh=inf, fill=inf),
        defer_until=mix(req.defer_until, fresh=0.0),
        n_defers=mix(req.n_defers, fresh=0),
        n_throttles=mix(req.n_throttles, fresh=0),
    )
    return new_batch, new_req


def _apply_body(policy: PolicyConfig, batch: RequestBatch, state: SimState,
                d, accepted: torch.Tensor, delay_ms: torch.Tensor
                ) -> SimState:
    """Post-dispatch transition on the (W,) pool: the live sibling of
    the engine's `_apply_batch`, with two differences.  Admits keep
    finish_ms = inf (the transport decides when work lands; completion
    comes through the provider poll), and the throttle verdict is the
    provider's actual submit response (`accepted`) with the session's
    retry policy giving `delay_ms`.  A bounce refunds the allocation
    charge in ADRR mode as the engine does (summed as `sum32`), gated on
    an actual bounce so the no-throttle path keeps `d.deficit`'s bits."""
    w = batch.n
    req = state.req
    now = state.now_ms
    asked = d.actions == olc.ADMIT
    admit = asked & accepted
    throttled = asked & ~accepted
    defer = d.actions == olc.DEFER
    reject = d.actions == olc.REJECT
    idx = d.req_idx
    safe = torch.clamp(idx, 0, w - 1)
    backoff = olc.defer_backoff(policy, d.severity, take(req.n_defers, safe))

    status = _set_drop(
        req.status, idx,
        torch.where(admit, INFLIGHT, REJECTED).to(torch.int32),
        admit | reject)
    submit = _set_drop(req.submit_ms, idx, now.expand(idx.shape), admit)
    defer_until = _set_drop(req.defer_until, idx, now + backoff, defer)
    defer_until = _set_drop(defer_until, idx, now + delay_ms, throttled)
    n_defers = _set_drop(req.n_defers, idx, 1, defer, accumulate=True)
    n_throttles = _set_drop(req.n_throttles, idx, 1, throttled,
                            accumulate=True)

    deficit = d.deficit
    if policy.alloc_mode == ALLOC_ADRR:
        k = deficit.shape[0]
        gcls = torch.clamp(take(batch.cls, safe), 0, k - 1)
        karange = torch.arange(k, dtype=torch.int32, device=gcls.device)
        refund = sum32((gcls[:, None] == karange).float()
                       * take(batch.p50, safe)[:, None]
                       * throttled[:, None].float(), dim=0)
        deficit = torch.where(
            throttled.any() & torch.isfinite(deficit + refund).all(),
            deficit + refund, deficit)

    provider = state.provider
    return state._replace(
        req=req._replace(
            status=status,
            submit_ms=submit,
            defer_until=defer_until,
            n_defers=n_defers,
            n_throttles=n_throttles,
        ),
        sched=state.sched._replace(deficit=deficit, rr_turn=d.rr_turn),
        provider=provider._replace(
            inflight=provider.inflight + admit.sum(dtype=torch.int32),
            inflight_tokens=provider.inflight_tokens + sum32(
                torch.where(admit, take(batch.p50, safe), 0.0)),
            n_throttled=provider.n_throttled + throttled.sum(
                dtype=torch.int32),
        ),
    )


def _fused_tick(policy: PolicyConfig, phys: ProviderPhysics,
                batch: RequestBatch, state: SimState, prev, comp, staged,
                n_stage: int, now: torch.Tensor, resub=None, *,
                max_grants: int, backend: str):
    """One decision epoch:

      apply(prev) -> charge resubmits -> ingest completions -> retire
                  -> compact + admit -> dispatch -> packed summary

    `prev` is the previous epoch's `(BatchDecision, accepted, delay_ms)`
    or None (the first epoch, or after a `_state` flush).  `comp` is the
    completion scatter `(slots, finish_ms)` or None, `staged` the (7,
    n_stage) staged arrivals, `now` the () float32 clock, `resub` the
    (K,) deficit charge of this epoch's watchdog resubmissions or None
    (a session without a resilience layer).  Returns the new pool, the
    new state, the decision and the summary `[actions, req_idx,
    inflight_at, backoff, severity, next_defer]` (ints exact in
    float32)."""
    if prev is not None:
        d0, acc0, delay0 = prev
        state = _apply_body(policy, batch, state, d0, acc0, delay0)
    if resub is not None:
        state = state._replace(sched=state.sched._replace(
            deficit=charge_resubmit(policy, state.sched.deficit, resub)))
    finish = state.req.finish_ms
    if comp is not None:
        slots, fins = comp
        finish = finish.index_put((slots,), fins)
    state = state._replace(now_ms=now,
                           req=state.req._replace(finish_ms=finish))
    state = _complete_and_timeout(policy, phys, batch, state)
    status = state.req.status
    alive = (status == PENDING) | (status == INFLIGHT)
    batch, req = _compact_and_admit(batch, state.req, alive, staged, n_stage)
    state = state._replace(req=req)
    d = schedule_batch(policy, batch, state, max_grants=max_grants,
                       backend=backend)
    # idle-sleep hint: the earliest defer/Retry-After expiry on the books
    # (this epoch's defers are added host-side from `backoff`)
    pend = req.status == PENDING
    next_defer = torch.where(pend & (req.defer_until > now), req.defer_until,
                             float("inf")).min()
    safe = torch.clamp(d.req_idx, 0, batch.n - 1)
    backoff = olc.defer_backoff(policy, d.severity, take(req.n_defers, safe))
    summary = torch.cat([
        d.actions.float(),
        d.req_idx.float(),
        d.inflight_at.float(),
        backoff,
        d.severity.reshape(1),
        next_defer.reshape(1),
    ])
    return batch, state, d, summary


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


class ClientSession:
    """Streaming three-layer client over an `AsyncProvider`.

    Lifecycle: `submit()` any number of requests over time (admission
    into the window is FIFO by submission order; keep arrivals
    nondecreasing when replaying a trace), `poll()` one decision epoch,
    `drain()` until everything submitted is terminal.

    `phys` is the client's latency model: the unloaded-latency
    expectation the tail EMA normalizes observed completions against.
    `resilience` arms the watchdog (`client/resilience.py`); None is the
    trusting session.  Duplicate-safe ingestion is not gated on it.

    `device` is where the pool lives and the tick runs: CUDA unless the
    caller names another (`resolve_device`; it raises without a card).
    On the card the session builds and first launches its kernels before
    its clock starts (`_warmup`), and a build or launch failure raises.
    """

    def __init__(
        self,
        provider: AsyncProvider,
        policy: PolicyConfig,
        cfg: SessionConfig = SessionConfig(),
        *,
        clock: str = "wall",
        phys: ProviderPhysics | None = None,
        retry_policy: RetryPolicy | None = None,
        resilience: ResilienceConfig | None = None,
        device=DEFAULT_DEVICE,
    ):
        if clock not in ("wall", "virtual"):
            raise ValueError(f"clock must be 'wall' or 'virtual', got {clock!r}")
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown ordering backend: {cfg.backend!r}")
        self.device = resolve_device(device)
        self.provider = provider
        self.policy = policy
        self.cfg = cfg
        self.clock = clock
        self.phys = phys if phys is not None else default_physics()
        self.retry_policy = retry_policy or honor_retry_after
        self.stats = SessionStats()
        self._prof: Optional[dict] = None
        # the policy and physics live on the device for the session
        self._policy_d, self._phys_d = to_device((policy, self.phys),
                                                 self.device)

        w = cfg.window
        self._k = n_classes(policy)
        self._pending = None  # (BatchDecision, verdicts) to fold in
        self._idle_cache: Optional[PollResult] = None
        # host mirrors, in lockstep with the device pool; the float32
        # fields replay the device's comparison chains bit for bit
        self._reqs: list[Request] = []
        self._arrival_ms: list[float] = []
        # columnar staging features, filled at submit(): queue pops are a
        # contiguous rid range, so staging is seven slice copies
        self._cols: tuple[list, ...] = tuple([] for _ in range(7))
        self._queue: deque[int] = deque()
        self._slot_rid = np.full(w, -1, np.int64)
        self._slot_status = np.full(w, REJECTED, np.int32)
        self._slot_arrival = np.zeros(w, np.float32)
        self._slot_thresh = np.full(w, np.inf, np.float32)
        self._slot_finish = np.full(w, np.inf, np.float32)
        self._n_live = 0
        self._tickets: dict[int, int] = {}
        self._unfinished = 0
        self._t = 0
        self._t0: Optional[float] = None
        self._defer_hint = float("inf")
        self._timeout_mult = policy.timeout_mult.cpu().numpy().astype(
            np.float32)
        self._staged_px = np.zeros((7, w), np.float32)
        self._watchdog = (Watchdog(resilience, self.phys)
                          if resilience is not None else None)
        # (K,) per-class deficit charge of this epoch's resubmissions
        self._resub_charge = np.zeros(self._k, np.float32)
        self._bm = min(int(cfg.max_grants), w)
        self._accdelay = np.zeros(2 * self._bm, np.float32)
        if self.device.type == "cuda":
            # one pinned buffer for every push, sized for the largest (now,
            # the (2, W) completions, the (7, W) staging rows, the (2B,)
            # verdicts, the (K,) charge), and the event of its last copy
            self._host = torch.empty(1 + 9 * w + 2 * self._bm + self._k,
                                     dtype=torch.float32, pin_memory=True)
            self._host_np = self._host.numpy()
            self._copied = torch.cuda.Event()
        self._reset_pool()
        self._warmup()

    def _reset_pool(self) -> None:
        w = self.cfg.window
        self._win_batch = empty_window_batch(w, self.device)
        self._dev_state = init_sim_state(w, self._k, self.device)._replace(
            req=empty_window_request_state(w, self.device))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """`arr` (float32) on the session's device.  To CUDA it goes
        through the session's pinned buffer without blocking the host;
        the buffer is overwritten only once its last copy is done (at one
        push a poll that copy ended before the last summary pull, so the
        wait costs nothing).  On the CPU it is a copy, since the caller
        may reuse `arr`."""
        if self.device.type != "cuda":
            return torch.from_numpy(arr.copy())
        n = arr.size
        self._copied.synchronize()
        self._host_np[:n] = arr
        out = self._host[:n].to(self.device, non_blocking=True)
        self._copied.record()
        return out

    def _step(self, prev_ad, slots, fins, n_stage: int, now32):
        """Pack this poll's push, upload it once and run the fused tick.
        `prev_ad` is the pending decision's (2B,) verdicts or None,
        `slots`/`fins` the completion scatter (float32, possibly empty)."""
        b = self._bm
        parts = [np.full(1, now32, np.float32), slots, fins,
                 self._staged_px[:, :n_stage].ravel(),
                 _EMPTY if prev_ad is None else prev_ad,
                 _EMPTY if self._watchdog is None else self._resub_charge]
        now, slots_d, fins_d, staged, verdicts, resub = torch.split(
            self._upload(np.concatenate(parts)), [len(x) for x in parts])
        comp = (slots_d.long(), fins_d) if len(slots) else None
        prev = (None if prev_ad is None else
                (self._pending[0], verdicts[:b] != 0.0, verdicts[b:]))
        return _fused_tick(
            self._policy_d, self._phys_d, self._win_batch, self._dev_state,
            prev, comp, staged.view(7, n_stage), n_stage, now.reshape(()),
            None if self._watchdog is None else resub,
            max_grants=self.cfg.max_grants, backend=self.cfg.backend)

    @property
    def _state(self) -> SimState:
        """Post-apply device state.  The fused tick leaves the previous
        epoch's transition pending (it is folded into the next poll);
        introspection flushes it first, so callers always see the state
        as if the epoch had been applied at once."""
        if self._pending is not None:
            d, ad = self._pending
            b = self._bm
            v = self._upload(ad)
            self._dev_state = _apply_body(
                self._policy_d, self._win_batch, self._dev_state, d,
                v[:b] != 0.0, v[b:])
            self._pending = None
        return self._dev_state

    def _warmup(self) -> None:
        """Run the session's device step once with and once without the
        leading apply, and the flush, on throwaway state before the clock
        starts: on the card this builds the ordering kernels (nvcc, at
        first use in the process) and launches them once, which a
        wall-clock session would otherwise spend as session time inside
        its first poll.  A build or launch failure raises here."""
        t0 = np.float32(0.0)
        self._win_batch, self._dev_state, d1, _ = self._step(
            None, _EMPTY, _EMPTY, 0, t0)
        self._accdelay[:self._bm] = 1.0
        self._pending = (d1, self._accdelay)
        self._win_batch, self._dev_state, d2, s2 = self._step(
            self._accdelay, _EMPTY, _EMPTY, 0, t0)
        self._pending = (d2, self._accdelay)
        _ = self._state
        s2.cpu()
        self._pending = None
        self._reset_pool()

    # --- clock --------------------------------------------------------
    def _wall_now_ms(self) -> float:
        if self._t0 is None:
            self._t0 = time.monotonic()
        return (time.monotonic() - self._t0) * 1e3 * self.cfg.time_scale

    def now_ms(self) -> float:
        if self.clock == "virtual":
            return float(np.float32(self._t) * np.float32(self.cfg.dt_ms))
        return self._wall_now_ms()

    # --- lifecycle ----------------------------------------------------
    def submit(self, req: Request) -> int:
        """Register a request; returns its session rid.  `arrival_s` is
        honored as given (0.0 = arrived at session start)."""
        rid = len(self._reqs)
        self._reqs.append(req)
        arrival = float(np.float32(req.arrival_s * 1000.0))
        self._arrival_ms.append(arrival)
        bkt = int(req.bucket)
        c = self._cols
        c[_ST_ARRIVAL].append(arrival)
        c[_ST_BUCKET].append(bkt)
        c[_ST_CLS].append(req.resolved_cls())
        c[_ST_TOKENS].append(float(req.max_new))
        c[_ST_P50].append(float(req.p50))
        c[_ST_P90].append(float(req.resolved_p90()))
        c[_ST_DEADLINE].append(_DEADLINE_PY[bkt])
        self._queue.append(rid)
        self._unfinished += 1
        self._idle_cache = None
        return rid

    @property
    def unfinished(self) -> int:
        return self._unfinished

    def enable_profiling(self) -> dict:
        """Turn on per-poll wall-time accounting and return the live
        accumulator dict.  Buckets (seconds, summed over profiled polls):
        `stage`, host work (completion ingest, retirement classification,
        arrival staging, mirror compaction); `dispatch`, the fused tick's
        call (the push and the ops' enqueue; on the card the device runs
        concurrently with the mirror work); `pull`, the blocking summary
        fetch, i.e. time waiting on the device; `grants`, the provider
        submit loop and verdict bookkeeping.  `polls` counts profiled
        epochs (the post-drain idle fast path, which does no device work,
        is not one)."""
        self._prof = {"stage": 0.0, "dispatch": 0.0, "pull": 0.0,
                      "grants": 0.0, "polls": 0}
        return self._prof

    def requests(self) -> list[Request]:
        return list(self._reqs)

    def _stage_admissions(self, now_ms: float, free: int) -> list[int]:
        """Pop arrived requests off the FIFO queue into the prefix of the
        staging buffer (the engine's window-admission rule).  Columns
        past the returned count are not pushed."""
        rids = []
        while self._queue and len(rids) < free \
                and self._arrival_ms[self._queue[0]] <= now_ms:
            rids.append(self._queue.popleft())
        if not rids:
            return rids
        r0, n = rids[0], len(rids)
        px = self._staged_px
        for row, col in enumerate(self._cols):
            px[row, :n] = col[r0:r0 + n]
        return rids

    def _run_watchdog(self, now_ms: float, now32: np.float32, nl: int,
                      comp_by_rid: dict) -> None:
        """The resilience pass: resubmit overdue in-flight requests within
        budget; give up (a synthetic completion the retirement chain
        classifies timed out -> ABANDONED) once the budget is gone and
        the slot's own timeout threshold has passed.  Mutates
        `comp_by_rid` and the ticket map only."""
        wd = self._watchdog
        for rid in wd.overdue(now_ms):
            if rid in comp_by_rid:
                continue  # landed this very epoch; retirement untracks it
            slot = int(np.searchsorted(self._slot_rid[:nl], rid))
            if slot >= nl or self._slot_rid[slot] != rid \
                    or self._slot_status[slot] != INFLIGHT:
                for t in wd.note_terminal(rid):
                    self._tickets.pop(t, None)
                continue
            r = self._reqs[rid]
            if wd.budget_left(rid):
                res = self.provider.submit(r, now_ms)
                if res.accepted:
                    # the attempts race: the old ticket stays mapped,
                    # the first completion wins, the loser is discarded
                    self._tickets[res.ticket] = rid
                    wd.note_resubmit(rid, r, res.ticket, now_ms)
                    r.n_resubmits += 1
                    cls = min(max(r.resolved_cls(), 0), self._k - 1)
                    self._resub_charge[cls] += np.float32(r.p50)
                    self.stats.n_resubmitted += 1
                else:
                    # 429 on the recovery path: no budget consumed
                    r.n_throttles += 1
                    delay = self.retry_policy(
                        sanitize_retry_after_ms(res.retry_after_ms),
                        r.n_throttles)
                    wd.note_bounced(rid, float(delay), now_ms)
                    self.stats.n_throttled += 1
                continue
            # budget exhausted: once the slot's end-to-end threshold has
            # passed (the classifier's own float32 comparison), a synthetic
            # completion stamped `now` classifies timed out -> ABANDONED
            if np.float32(now32 - self._slot_arrival[slot]) \
                    > self._slot_thresh[slot]:
                wd.give_up(rid)
                self.stats.n_gave_up += 1
                comp_by_rid[rid] = Completion(-1, float(now32), None)

    def poll(self, now_ms: Optional[float] = None) -> PollResult:
        """One decision epoch: one fused device step plus the host side of
        the provider boundary (submit grants, collect 429 verdicts).
        O(W + B) whatever the session's history."""
        self._t += 1
        if now_ms is None:
            now_ms = self.now_ms() if self.clock == "wall" else float(
                np.float32(np.float32(self._t) * np.float32(self.cfg.dt_ms)))
        b = self._bm
        self.stats.n_polls += 1

        # post-drain fast path: an empty pool with nothing queued and
        # nothing in flight is a fixpoint, replayed with no device work
        if (self._idle_cache is not None and not self._queue
                and not self._tickets and not self._unfinished):
            return self._idle_cache._replace(now_ms=now_ms)

        prof = self._prof
        if prof is not None:
            _tp0 = time.perf_counter()
        now32 = np.float32(now_ms)
        nl = self._n_live

        # 1. provider completions -> completion scatter + finish mirror.
        # Duplicate-safe: the first arrival for a rid wins; a redelivered
        # ticket, a raced attempt whose sibling landed, or a completion
        # for a retired rid is discarded here, before the scatter
        comps = self.provider.poll(now_ms)
        comp_by_rid: dict[int, Completion] = {}
        for c in comps:
            rid = self._tickets.pop(c.ticket, None)
            if rid is None or rid in comp_by_rid:
                self.stats.n_dup_discarded += 1
                continue
            comp_by_rid[rid] = c
        if self._watchdog is not None:
            self._run_watchdog(now_ms, now32, nl, comp_by_rid)
        slots = fins = _EMPTY
        if comp_by_rid:
            rid_list = sorted(comp_by_rid)
            rids = np.asarray(rid_list, np.int64)
            pos = np.searchsorted(self._slot_rid[:nl], rids)
            if nl:
                live = ((pos < nl)
                        & (self._slot_rid[np.minimum(pos, nl - 1)] == rids))
            else:
                live = np.zeros(len(rids), bool)
            if not live.all():
                # late arrival: the rid no longer holds a window slot
                for i in np.nonzero(~live)[0]:
                    del comp_by_rid[rid_list[i]]
                    self.stats.n_late_discarded += 1
                rids, pos = rids[live], pos[live]
                rid_list = [r for r in rid_list if r in comp_by_rid]
            if len(rids):
                fins = np.asarray(
                    [comp_by_rid[r].finish_ms for r in rid_list], np.float32)
                slots = pos.astype(np.float32)
                self._slot_finish[pos] = fins

        # 2. retirement classification on the float32 mirrors: the
        # comparison chains `_complete_and_timeout` runs on the device
        st = self._slot_status[:nl]
        arr = self._slot_arrival[:nl]
        fin = self._slot_finish[:nl]
        th = self._slot_thresh[:nl]
        landed = (st == INFLIGHT) & (fin <= now32)
        timed_out = landed & ((fin - arr) > th)
        stale = (st == PENDING) & (arr <= now32) & ((now32 - arr) > th)
        dead = landed | stale
        completed: list[int] = []
        abandoned: list[int] = []
        for slot in np.nonzero(dead)[0]:
            rid = int(self._slot_rid[slot])
            r = self._reqs[rid]
            if landed[slot] and not timed_out[slot]:
                c = comp_by_rid.get(rid)
                r.status = "completed"
                r.finish_s = float(fin[slot]) / 1e3 \
                    if c is None else float(c.finish_ms) / 1e3
                if c is not None:
                    r.output = c.output
                completed.append(rid)
                self.stats.n_completed += 1
            else:
                # stale pending, or landed past the timeout multiple
                r.status = "abandoned"
                abandoned.append(rid)
                self.stats.n_abandoned += 1
            self._unfinished -= 1
            if self._watchdog is not None:
                # unmap every racing ticket the rid still holds
                for t in self._watchdog.note_terminal(rid):
                    self._tickets.pop(t, None)
        alive = ((st == PENDING) | (st == INFLIGHT)) & ~dead
        n_alive = int(alive.sum())

        # 3. stage arrivals + 4. the fused device step
        staged_rids = self._stage_admissions(now_ms, self.cfg.window - n_alive)
        n_stage = len(staged_rids)
        if prof is not None:
            _tp1 = time.perf_counter()
        prev_ad = self._pending[1] if self._pending is not None else None
        self._win_batch, self._dev_state, d, summary = self._step(
            prev_ad, slots, fins, n_stage, now32)
        if prof is not None:
            _tp2 = time.perf_counter()
        if self._watchdog is not None and self._resub_charge.any():
            self._resub_charge[:] = 0.0

        # 5. mirror compaction (in lockstep with the device's)
        nt = n_alive + n_stage
        self._slot_rid[:n_alive] = self._slot_rid[:nl][alive]
        self._slot_status[:n_alive] = st[alive]
        self._slot_arrival[:n_alive] = arr[alive]
        self._slot_thresh[:n_alive] = th[alive]
        self._slot_finish[:n_alive] = fin[alive]
        if n_stage:
            sl = slice(n_alive, nt)
            self._slot_rid[sl] = staged_rids
            self._slot_status[sl] = PENDING
            px = self._staged_px
            self._slot_arrival[sl] = px[_ST_ARRIVAL, :n_stage]
            self._slot_thresh[sl] = (
                self._timeout_mult[px[_ST_BUCKET, :n_stage].astype(np.int64)]
                * px[_ST_DEADLINE, :n_stage])
            self._slot_finish[sl] = np.inf
            for rid in staged_rids:
                self._reqs[rid].status = "pending"
        self._slot_rid[nt:self._n_live] = -1
        self._slot_status[nt:self._n_live] = REJECTED
        self._n_live = nt

        # 6. submit grants (decision order); collect 429 verdicts
        if prof is not None:
            _tp3 = time.perf_counter()
        summary = summary.cpu().numpy()  # the one device->host pull
        if prof is not None:
            _tp4 = time.perf_counter()
        actions = summary[0:b].astype(np.int32)
        idxs = summary[b:2 * b].astype(np.int32)
        infl_at = summary[2 * b:3 * b].astype(np.int32)
        backoff = summary[3 * b:4 * b]
        severity = np.float32(summary[4 * b])
        dev_next_defer = float(summary[4 * b + 1])
        ad = self._accdelay
        ad[:b] = 1.0
        ad[b:] = 0.0
        req_rids = np.full(b, -1, np.int64)
        admitted, deferred, rejected, throttled = [], [], [], []
        for g in range(b):
            a = actions[g]
            if a == IDLE:
                continue
            slot = idxs[g]
            rid = int(self._slot_rid[slot])
            req_rids[g] = rid
            r = self._reqs[rid]
            if a == olc.ADMIT:
                res = self.provider.submit(
                    r, now_ms, inflight_hint=int(infl_at[g]))
                if res.accepted:
                    self._tickets[res.ticket] = rid
                    r.status = "inflight"
                    r.submit_s = now_ms / 1e3
                    self._slot_status[slot] = INFLIGHT
                    admitted.append(rid)
                    self.stats.n_admitted += 1
                    if self._watchdog is not None:
                        self._watchdog.note_admit(rid, r, res.ticket, now_ms)
                else:
                    ad[g] = 0.0
                    r.n_throttles += 1
                    # the float32 store rounds the delay as an explicit
                    # np.float32 cast; the hint is sanitized first, so a
                    # hostile one cannot date a defer in the past or
                    # poison the idle-sleep hint
                    ad[b + g] = self.retry_policy(
                        sanitize_retry_after_ms(res.retry_after_ms),
                        r.n_throttles)
                    throttled.append(rid)
                    self.stats.n_throttled += 1
            elif a == olc.DEFER:
                r.n_defers += 1
                deferred.append(rid)
                self.stats.n_deferred += 1
            else:  # REJECT
                r.status = "rejected"
                self._slot_status[slot] = REJECTED
                rejected.append(rid)
                self.stats.n_rejected += 1
                self._unfinished -= 1

        # 7. the device transition folds into the next poll's step
        self._pending = (d, ad)
        self.stats.peak_inflight = max(
            self.stats.peak_inflight, self.provider.inflight())
        hint = dev_next_defer
        if deferred:
            hint = min(hint, float(
                (now32 + backoff[actions == olc.DEFER]).min()))
        if throttled:
            bounced = ad[:b] == 0.0
            hint = min(hint, float((now32 + ad[b:][bounced]).min()))
        self._defer_hint = hint

        if prof is not None:
            _tp5 = time.perf_counter()
            prof["stage"] += (_tp1 - _tp0) + (_tp3 - _tp2)
            prof["dispatch"] += _tp2 - _tp1
            prof["pull"] += _tp4 - _tp3
            prof["grants"] += _tp5 - _tp4
            prof["polls"] += 1
        progressed = bool(
            completed or abandoned or rejected or admitted or deferred
            or throttled or staged_rids)
        result = PollResult(
            now_ms=now_ms, actions=actions, req_rids=req_rids,
            severity=severity, completed=completed, abandoned=abandoned,
            rejected=rejected, admitted=admitted, deferred=deferred,
            throttled=throttled, n_live=self._n_live, progressed=progressed)
        if (not progressed and not self._unfinished and not self._queue
                and not self._tickets and nt == 0 and len(slots) == 0):
            self._idle_cache = result
        return result

    # --- drain --------------------------------------------------------
    def _idle_sleep(self, now_ms: float) -> None:
        """Sleep until the next actionable instant instead of spinning:
        the next queued arrival, the earliest defer/Retry-After expiry,
        a watchdog deadline or the provider's next-event hint, capped so
        an unhintable transport is still polled."""
        cands = []
        if self._queue:
            cands.append(self._arrival_ms[self._queue[0]])
        if np.isfinite(self._defer_hint):
            cands.append(self._defer_hint)
        if self._watchdog is not None:
            nd = self._watchdog.next_deadline_ms()
            if np.isfinite(nd):
                cands.append(nd)
        pe = self.provider.next_event_ms(now_ms)
        if pe is not None:
            cands.append(pe)
        # a candidate already due (a queued arrival behind a full window)
        # is no wakeup signal: it would clamp the sleep to zero
        cands = [c for c in cands if c > now_ms]
        target = min(cands) if cands else now_ms + self.cfg.max_idle_sleep_ms
        target = min(target, now_ms + self.cfg.max_idle_sleep_ms)
        sleep_s = (target - now_ms) / 1e3 / self.cfg.time_scale
        if sleep_s > 0:
            self.stats.n_idle_sleeps += 1
            time.sleep(sleep_s)

    def _live_slot_report(self, limit: int = 16) -> str:
        """The occupied window slots for liveness diagnostics: (rid,
        status, age_ms) triples."""
        names = {PENDING: "pending", INFLIGHT: "inflight"}
        nl = self._n_live
        now = np.float32(self.now_ms())
        rows = []
        for slot in range(nl):
            st = int(self._slot_status[slot])
            if st not in names:
                continue
            rows.append(
                f"(rid={int(self._slot_rid[slot])} {names[st]} "
                f"age={float(now - self._slot_arrival[slot]):.0f}ms)")
        extra = f" ... +{len(rows) - limit} more" if len(rows) > limit else ""
        return " ".join(rows[:limit]) + extra

    def drain(self, max_polls: Optional[int] = None,
              max_idle_ms: Optional[float] = None) -> list[Request]:
        """Poll until every submitted request is terminal.  Wall-clock
        sessions sleep through idle epochs; virtual sessions advance one
        tick a poll.  Ends with one settling epoch that compacts the last
        retirements out of the pool and primes the idle fast path.
        Returns the session's requests.

        `max_idle_ms` is the liveness guard: if no poll makes progress for
        that much session time (a completion that will never arrive), the
        drain raises a RuntimeError naming the live slots, the provider's
        inflight count and the last-progress time.  None waits forever."""
        n = 0
        last_progress: Optional[float] = None
        while self._unfinished:
            r = self.poll()
            n += 1
            if last_progress is None or r.progressed:
                last_progress = r.now_ms
            if self._unfinished and max_polls is not None and n >= max_polls:
                raise RuntimeError(
                    f"drain: {self._unfinished} request(s) still live "
                    f"after {n} polls")
            if (max_idle_ms is not None and self._unfinished
                    and r.now_ms - last_progress > max_idle_ms):
                raise RuntimeError(
                    f"drain: no progress for "
                    f"{r.now_ms - last_progress:.0f} ms (cap "
                    f"{max_idle_ms:.0f} ms): {self._unfinished} "
                    f"unfinished, {self.provider.inflight()} "
                    f"provider-inflight, last progress at "
                    f"t={last_progress:.0f} ms (now t={r.now_ms:.0f} ms); "
                    f"live slots: {self._live_slot_report()}")
            if self.clock == "wall" and not r.progressed:
                self._idle_sleep(r.now_ms)
        if not self._queue and not self._tickets \
                and self._idle_cache is None:
            self.poll()  # settle: retire bookkeeping, prime the fast path
        return list(self._reqs)
