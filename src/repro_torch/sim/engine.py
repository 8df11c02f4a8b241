"""Tick-driven discrete-event engine, as a Python tick loop.

Counterpart of `repro.sim.engine` (stationary provider).  Each tick:

  1. completions (finish_ms <= now) -> COMPLETED, update the tail EMA;
  2. timeouts (pending too long)    -> ABANDONED;
  3. one batched dispatch pass (`schedule_batch`): up to `k_slots`
     grants, applied as one set of scatters.

With `SimConfig.window = W` the loop carries a compacted (W,) slot pool
(`WindowCarry`) holding exactly the live queue: each tick retires
terminal slots into the dense (N,) result arrays, compacts the
survivors stably, admits new arrivals off the arrival-sorted stream
with one `searchsorted`, and runs the same `schedule_batch` on the
(K, W) view.  With W at or above the peak live queue the windowed run
is bit-exact with the dense one.

Where the reference scatters with the out-of-range index n and
`mode="drop"`, the port scatters into a copy with one spare tail slot
and slices it off (`_set_drop`).  The tick body reads nothing back to
the host, so on CUDA the loop only enqueues work.

Provider dynamics (`sim/provider.ProviderDynamics`): each tick reads its
row of the schedules.  A brownout's `comfort_scale[t]` prices the
tick's admits; a token-bucket limiter refills each class's bucket after
the retire pass and before dispatch, `min(tokens + refill[t],
capacity)`, and an admit that finds its bucket out of grants bounces:
it stays PENDING, retries `retry_after_ms` later, and its DRR charge is
refunded in ADRR mode.  The fleet axis is not part of this package yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import overload as olc
from repro_torch.core.numerics import fma32, pinned, sum32
from repro_torch.core.policy import ALLOC_ADRR, PolicyConfig, n_classes
from repro_torch.core.scheduler import (
    BatchDecision,
    refund_deficit,
    schedule_batch,
)
from repro_torch.core.types import (
    ABANDONED,
    COMPLETED,
    INFLIGHT,
    PENDING,
    REJECTED,
    RequestBatch,
    RequestState,
    SimState,
    WindowCarry,
    init_sim_state,
    init_window_carry,
    take,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.sim.provider import (
    ProviderDynamics,
    ProviderPhysics,
    load_multiplier,
    unloaded_latency_ms,
)

EMA_ALPHA = 0.15

# Width of the per-tick EMA completion sample: the first EMA_SAMPLE_CAP
# completions in request-id order, as in the reference.
EMA_SAMPLE_CAP = 128


class SimConfig(NamedTuple):
    dt_ms: float = 25.0
    n_ticks: int = 6000
    k_slots: int = 4                  # max grants per tick (batch width B)
    ordering_backend: str = "kernel"  # "kernel" (hand kernel) | "torch"
    window: Optional[int] = None      # active-window capacity W; None = dense


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, values,
              keep: torch.Tensor, accumulate: bool = False) -> torch.Tensor:
    """`arr` with `arr[idx[j]] = values[j]` (or `+=`) where `keep[j]`;
    rows not kept land on a spare tail slot that is sliced off."""
    n = arr.shape[0]
    target = torch.where(keep, idx.long(), n)
    out = torch.cat([arr, arr[:1]])
    if not isinstance(values, torch.Tensor):
        values = torch.full(target.shape, values, dtype=arr.dtype,
                            device=arr.device)
    out.index_put_((target,), values.to(arr.dtype), accumulate=accumulate)
    return out[:n]


def _completed_ratio_sum(phys: ProviderPhysics, done_now, finish_ms,
                         arrival_ms, tokens):
    """Tail-EMA contribution of this tick's completions: the sum of
    observed/expected latency over the first EMA_SAMPLE_CAP completions
    in index order (request-id order in both engine representations),
    accumulated in float64 and rounded once, so dense, windowed, CPU and
    CUDA runs all give the same float32.  Returns (ratio_sum, count)."""
    rank = torch.cumsum(done_now, 0, dtype=torch.int32)
    k = done_now.sum(dtype=torch.int32)
    live = done_now & (rank <= EMA_SAMPLE_CAP)
    expected = unloaded_latency_ms(phys, tokens)
    ratio = torch.where(
        live, (finish_ms - arrival_ms) / torch.clamp(expected, min=1.0), 0.0)
    return pinned(sum32(ratio)), k


def _complete_and_timeout(cfg: PolicyConfig, phys: ProviderPhysics,
                          batch: RequestBatch, state: SimState) -> SimState:
    req = state.req
    now = state.now_ms
    landed = (req.status == INFLIGHT) & (req.finish_ms <= now)
    # a request whose end-to-end latency blew past timeout_mult x its
    # deadline budget is a failure, not a completion
    patience = take(cfg.timeout_mult, batch.bucket) * batch.deadline_budget_ms
    timed_out = landed & (req.finish_ms - batch.arrival_ms > patience)
    done_now = landed & ~timed_out
    status = torch.where(done_now, COMPLETED,
                         torch.where(timed_out, ABANDONED, req.status))

    ratio_sum, k = _completed_ratio_sum(
        phys, done_now, req.finish_ms, batch.arrival_ms, batch.true_tokens)
    k_sample = torch.clamp(k, max=EMA_SAMPLE_CAP)
    mean_ratio = torch.where(
        k > 0, ratio_sum / torch.clamp(k_sample, min=1), 0.0)
    ema0 = state.sched.ema_latency_ratio
    delta = pinned(EMA_ALPHA * (mean_ratio - ema0))
    ema = torch.where(k > 0, ema0 + delta, ema0)

    # implicit client abandonment of stale pending work
    stale = ((status == PENDING) & (batch.arrival_ms <= now)
             & (now - batch.arrival_ms > patience))
    status = torch.where(stale, ABANDONED, status)
    in_flight = status == INFLIGHT

    return state._replace(
        req=req._replace(status=status),
        sched=state.sched._replace(
            ema_latency_ratio=ema,
            n_completed_obs=state.sched.n_completed_obs + k,
        ),
        provider=state.provider._replace(
            inflight=in_flight.sum(dtype=torch.int32),
            inflight_tokens=sum32(torch.where(in_flight, batch.p50, 0.0)),
        ),
    )


def _apply_batch(cfg: PolicyConfig, phys: ProviderPhysics,
                 batch: RequestBatch, jitter: torch.Tensor, state: SimState,
                 d: BatchDecision, comfort_scale=None,
                 limiter: ProviderDynamics | None = None) -> SimState:
    """State transition for up to B grants as one set of scatters.
    Grants target distinct requests, so the scatters never collide;
    idle rows are dropped.  `comfort_scale` is this tick's brownout
    value (None = stationary); `limiter` turns on the token bucket: the
    g-th admit of a class this batch goes through iff its bucket holds
    g grants (later grants were still decided against the optimistic
    inflight count, as a real client only sees the bounce after the
    send)."""
    n = batch.n
    req = state.req
    provider = state.provider
    now = state.now_ms
    admit = d.actions == olc.ADMIT
    defer = d.actions == olc.DEFER
    reject = d.actions == olc.REJECT
    idx = d.req_idx
    safe = torch.clamp(idx, 0, n - 1)  # idle rows may carry the sentinel n
    deficit = d.deficit
    throttled = None
    if limiter is not None:
        k = provider.tb_tokens.shape[0]
        gcls = torch.clamp(take(batch.cls, safe), 0, k - 1)
        karange = torch.arange(k, dtype=torch.int32, device=gcls.device)
        cls_admit = (gcls[:, None] == karange) & admit[:, None]   # (B, K)
        rank = (torch.cumsum(cls_admit, 0, dtype=torch.int32)
                * cls_admit).sum(dim=1)                           # 1-based
        allowed = rank.float() <= take(provider.tb_tokens, gcls) + 1e-6
        throttled = admit & ~allowed
        admit = admit & allowed
        consumed = (cls_admit & admit[:, None]).sum(dim=0).float()
        provider = provider._replace(
            tb_tokens=provider.tb_tokens - consumed,
            n_throttled=provider.n_throttled + throttled.sum(
                dtype=torch.int32))
        if cfg.alloc_mode == ALLOC_ADRR:
            # the 429 blocked a release the allocation layer charged for:
            # credit it back like a defer/reject refund
            deficit = refund_deficit(deficit, sum32(
                (gcls[:, None] == karange).float()
                * take(batch.p50, safe)[:, None]
                * throttled[:, None].float(), dim=0))

    # per-grant service at the inflight level the grant saw.  XLA:CPU
    # contracts the reference's trailing `service * jitter + now` into an
    # FMA; fma32 rounds that step once, identically on the CPU and CUDA.
    base = unloaded_latency_ms(phys, take(batch.true_tokens, safe)) * \
        load_multiplier(phys, d.inflight_at, comfort_scale)
    finish = fma32(base, take(jitter, safe), now)
    backoff = olc.defer_backoff(cfg, d.severity, take(req.n_defers, safe))

    status = _set_drop(
        req.status, idx,
        torch.where(admit, INFLIGHT, REJECTED).to(torch.int32),
        admit | reject)
    defer_until = _set_drop(req.defer_until, idx, now + backoff, defer)
    n_throttles = req.n_throttles
    if throttled is not None:
        defer_until = _set_drop(defer_until, idx,
                                (now + limiter.retry_after_ms).expand(
                                    idx.shape), throttled)
        n_throttles = _set_drop(n_throttles, idx, 1, throttled,
                                accumulate=True)
    admitted = admit.sum(dtype=torch.int32)
    return state._replace(
        req=req._replace(
            status=status,
            submit_ms=_set_drop(req.submit_ms, idx, now.expand(idx.shape),
                                admit),
            finish_ms=_set_drop(req.finish_ms, idx, finish, admit),
            defer_until=defer_until,
            n_defers=_set_drop(req.n_defers, idx, 1, defer, accumulate=True),
            n_throttles=n_throttles,
        ),
        sched=state.sched._replace(deficit=deficit, rr_turn=d.rr_turn),
        provider=provider._replace(
            inflight=provider.inflight + admitted,
            inflight_tokens=provider.inflight_tokens + sum32(
                torch.where(admit, take(batch.p50, safe), 0.0)),
        ),
    )


def _window_view(batch: RequestBatch, req: RequestState,
                 slot_req: torch.Tensor):
    """The window's (W,) view of the batch and request state.  Empty
    slots (sentinel id n) gather a real row but are neutralized:
    valid=False, terminal status, finish=inf.  Returns (win_batch,
    win_req, occupied)."""
    n = batch.n
    occ = slot_req < n
    safe = torch.clamp(slot_req, max=n - 1).long()
    win_batch = RequestBatch(*(f.index_select(0, safe) for f in batch))
    win_batch = win_batch._replace(valid=win_batch.valid & occ)
    win_req = RequestState(*(f.index_select(0, safe) for f in req))
    win_req = win_req._replace(
        status=torch.where(occ, win_req.status, REJECTED).to(torch.int32),
        finish_ms=torch.where(occ, win_req.finish_ms, float("inf")),
    )
    return win_batch, win_req, occ


def _retire_window(cfg, phys, batch, state: SimState, win: WindowCarry):
    """Windowed completion/timeout/stale pass: the dense transition on the
    (W,) view, then a scatter of the updated statuses into the dense
    arrays.  Returns (state, alive) with alive marking slots still
    PENDING or INFLIGHT."""
    win_batch, win_req, occ = _window_view(batch, state.req, win.slot_req)
    win_state = _complete_and_timeout(cfg, phys, win_batch,
                                      state._replace(req=win_req))
    status_w = win_state.req.status
    status = _set_drop(state.req.status, win.slot_req, status_w, occ)
    state = state._replace(
        req=state.req._replace(status=status),
        sched=win_state.sched,
        provider=win_state.provider,
    )
    alive = occ & ((status_w == PENDING) | (status_w == INFLIGHT))
    return state, alive


def _compact_and_admit(batch: RequestBatch, win: WindowCarry,
                       alive: torch.Tensor, now) -> WindowCarry:
    """Stable compaction of the survivors, then admission of new arrivals
    (in arrival order) into the free tail.  When the live queue exceeds
    W the overflow waits, FIFO by arrival."""
    n = batch.n
    w = win.slot_req.shape[0]
    iota = torch.arange(w, dtype=torch.int32, device=alive.device)
    pos = torch.cumsum(alive, 0, dtype=torch.int32) - 1
    slot_req = _set_drop(torch.full_like(win.slot_req, n), pos, win.slot_req,
                         alive)
    n_live = alive.sum(dtype=torch.int32)
    n_arrived = torch.searchsorted(batch.arrival_ms, now.reshape(1),
                                   right=True)[0].to(torch.int32)
    n_admit = torch.minimum(torch.clamp(n_arrived - win.arr_ptr, min=0),
                            w - n_live)
    admit_here = (iota >= n_live) & (iota < n_live + n_admit)
    slot_req = torch.where(admit_here, win.arr_ptr + iota - n_live, slot_req)
    return WindowCarry(slot_req=slot_req.to(torch.int32),
                       arr_ptr=win.arr_ptr + n_admit,
                       n_live=n_live + n_admit)


def sim_tick(policy: PolicyConfig, phys: ProviderPhysics,
             batch: RequestBatch, jitter: torch.Tensor, state: SimState,
             win: WindowCarry | None, now_ms: torch.Tensor, *,
             k_slots: int, backend: str, collect_decisions: bool = False,
             comfort_t=None, refill_t=None,
             limiter: ProviderDynamics | None = None):
    """One decision epoch: retire -> compact + admit -> limiter refill ->
    dispatch -> apply.  `win=None` runs the dense O(N) transition; a
    `WindowCarry` runs the O(W) active-window path.  `comfort_t` is the
    tick's brownout value, `refill_t` its (K,) bucket refill and
    `limiter` the dynamics holding the buckets' capacity and Retry-After
    (each None when off).  Returns (state, win, ys) with ys the tick's
    decision-trace row (actions, global req_idx, severity) or None."""
    state = state._replace(now_ms=now_ms)
    if win is not None:
        state, alive = _retire_window(policy, phys, batch, state, win)
        win = _compact_and_admit(batch, win, alive, now_ms)
    else:
        state = _complete_and_timeout(policy, phys, batch, state)
    if limiter is not None:
        state = state._replace(provider=state.provider._replace(
            tb_tokens=torch.minimum(state.provider.tb_tokens + refill_t,
                                    limiter.tb_capacity)))
    if win is not None:
        win_batch, win_req, _ = _window_view(batch, state.req, win.slot_req)
        d = schedule_batch(policy, win_batch, state._replace(req=win_req),
                           max_grants=k_slots, backend=backend)
        # slot-local decision -> global request ids (empty slots map to
        # the sentinel n, which only idle rows can carry)
        w = win.slot_req.shape[0]
        d = d._replace(
            req_idx=take(win.slot_req, torch.clamp(d.req_idx, 0, w - 1)))
    else:
        d = schedule_batch(policy, batch, state, max_grants=k_slots,
                           backend=backend)
    state = _apply_batch(policy, phys, batch, jitter, state, d,
                         comfort_scale=comfort_t, limiter=limiter)
    ys = (d.actions, d.req_idx, d.severity) if collect_decisions else None
    return state, win, ys


def run_sim(policy: PolicyConfig, batch: RequestBatch, jitter: torch.Tensor,
            phys: ProviderPhysics, sim_cfg: SimConfig = SimConfig(),
            dynamics: ProviderDynamics | None = None,
            collect_decisions: bool = False, fleet=None, *,
            device="cuda", on_tick=None):
    """Run the full horizon on `device`; returns the final SimState, or
    (final, (actions (T,B), req_idx (T,B), severity (T,))) with
    `collect_decisions=True` (req_idx in global request ids on both
    engines).  `dynamics` adds the provider's per-tick schedules (each
    at least `sim_cfg.n_ticks` long); the token buckets start full.
    Windowed mode needs `batch.arrival_ms` sorted ascending (the
    generator's native order).  `on_tick(t, state, win)`, when given,
    is called after every tick (win is None on the dense path) and must
    not modify what it is handed."""
    if fleet is not None and dynamics is not None:
        raise ValueError(
            "fleet and dynamics are mutually exclusive: use "
            "FleetDynamics for per-endpoint schedules")
    if fleet is not None:
        raise NotImplementedError(
            "the fleet axis is not ported yet: ROADMAP queue A, item A5(b)")
    dev = resolve_device(device)
    policy, phys, batch, jitter, dynamics = to_device(
        (policy, phys, batch, jitter, dynamics), dev)
    n = batch.n
    state = init_sim_state(n, n_classes(policy), dev)
    comfort = dynamics.comfort_scale if dynamics is not None else None
    limiter = (dynamics if dynamics is not None
               and dynamics.tb_refill is not None else None)
    if limiter is not None:
        state = state._replace(provider=state.provider._replace(
            tb_tokens=limiter.tb_capacity))
    win = (init_window_carry(sim_cfg.window, n, dev)
           if sim_cfg.window is not None else None)
    # tick t runs at (t + 1) * dt, rounded to float32 as in the reference
    nows = (torch.arange(1, sim_cfg.n_ticks + 1, dtype=torch.float32)
            * torch.tensor(sim_cfg.dt_ms, dtype=torch.float32)).to(dev)
    trace = []
    for t in range(sim_cfg.n_ticks):
        state, win, ys = sim_tick(
            policy, phys, batch, jitter, state, win, nows[t],
            k_slots=sim_cfg.k_slots, backend=sim_cfg.ordering_backend,
            collect_decisions=collect_decisions,
            comfort_t=None if comfort is None else comfort[t],
            refill_t=None if limiter is None else limiter.tb_refill[t],
            limiter=limiter)
        if collect_decisions:
            trace.append(ys)
        if on_tick is not None:
            on_tick(t, state, win)
    # drain: completions that land at or after the horizon
    final = state._replace(now_ms=state.now_ms + 1e9)
    if win is not None:
        # retire through the window first, then one dense pass reaches
        # the requests the window never admitted (the timeout rule)
        final, _ = _retire_window(policy, phys, batch, final, win)
    final = _complete_and_timeout(policy, phys, batch, final)
    if collect_decisions:
        return final, tuple(torch.stack(col) for col in zip(*trace))
    return final
