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
refunded in ADRR mode.

Fleet axis (`run_sim(..., fleet=Fleet(phys, dyn))`, P endpoints): a
down endpoint (`avail[t, p] < 0.5`) kills its in-flight work before the
tick's completions, and the engine requeues it (PENDING, a Retry-After
defer, a throttle bump, counted in `FleetState.n_requeued`); the
routing pass (`core/routing.py`) fixes each request's endpoint and
route term before dispatch; each grant is priced at its endpoint's own
physics and outstanding count; the limiter becomes a (P, K) bucket
grid.  At P == 1 the engine takes scalar gathers and no route term, so
the run is the single-provider run bit for bit.  `phys` stays the
reference physics the tail EMA's expectation is computed against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import overload as olc
from repro_torch.core.numerics import fma32, pinned, sum32
from repro_torch.core.policy import ALLOC_ADRR, PolicyConfig, n_classes
from repro_torch.core.routing import route_requests
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
    init_fleet_state,
    init_sim_state,
    init_window_carry,
    take,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.sim.provider import (
    Fleet,
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
                          batch: RequestBatch, state: SimState,
                          avail_t=None, retry_after_ms=None) -> SimState:
    """Completions, timeouts and stale abandonment.  With `avail_t` (the
    tick's (P,) availability row) a down endpoint first kills its
    in-flight work: it goes back to PENDING, waits `retry_after_ms`, and
    counts a throttle, before anything can land this tick."""
    req = state.req
    now = state.now_ms
    status0, finish_ms = req.status, req.finish_ms
    defer_until, n_throttles = req.defer_until, req.n_throttles
    requeue = None
    if avail_t is not None:
        down = take(avail_t, req.endpoint) < 0.5
        requeue = (status0 == INFLIGHT) & down
        status0 = torch.where(requeue, PENDING, status0).to(torch.int32)
        finish_ms = torch.where(requeue, float("inf"), finish_ms)
        defer_until = torch.where(requeue, now + retry_after_ms, defer_until)
        n_throttles = n_throttles + requeue.to(torch.int32)

    landed = (status0 == INFLIGHT) & (finish_ms <= now)
    # a request whose end-to-end latency blew past timeout_mult x its
    # deadline budget is a failure, not a completion
    patience = take(cfg.timeout_mult, batch.bucket) * batch.deadline_budget_ms
    timed_out = landed & (finish_ms - batch.arrival_ms > patience)
    done_now = landed & ~timed_out
    status = torch.where(done_now, COMPLETED,
                         torch.where(timed_out, ABANDONED, status0))

    ratio_sum, k = _completed_ratio_sum(
        phys, done_now, finish_ms, batch.arrival_ms, batch.true_tokens)
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

    fleet = state.fleet
    if fleet is not None:
        # per-endpoint recount over status: every INFLIGHT request
        # carries its endpoint (and lives in the window, when windowed)
        p = fleet.inflight.shape[0]
        ep_oh = req.endpoint[None, :] == torch.arange(
            p, dtype=torch.int32, device=now.device)[:, None]
        live = ep_oh & in_flight[None, :]
        fleet = fleet._replace(
            inflight=live.sum(dim=1, dtype=torch.int32),
            inflight_tokens=sum32(torch.where(live, batch.p50[None, :], 0.0),
                                  dim=1))
        if requeue is not None:
            fleet = fleet._replace(n_requeued=fleet.n_requeued + (
                ep_oh & requeue[None, :]).sum(dim=1, dtype=torch.int32))

    return state._replace(
        req=req._replace(status=status, finish_ms=finish_ms,
                         defer_until=defer_until, n_throttles=n_throttles),
        sched=state.sched._replace(
            ema_latency_ratio=ema,
            n_completed_obs=state.sched.n_completed_obs + k,
        ),
        provider=state.provider._replace(
            inflight=in_flight.sum(dtype=torch.int32),
            inflight_tokens=sum32(torch.where(in_flight, batch.p50, 0.0)),
        ),
        fleet=fleet,
    )


def _bucket_ranks(keys: torch.Tensor, n_keys: int, admit: torch.Tensor):
    """(B, n_keys) one-hot of each admit's bucket key and its 1-based
    rank among this batch's admits of the same key."""
    karange = torch.arange(n_keys, dtype=torch.int32, device=keys.device)
    key_admit = (keys[:, None] == karange) & admit[:, None]
    rank = (torch.cumsum(key_admit, 0, dtype=torch.int32)
            * key_admit).sum(dim=1)
    return key_admit, rank


def _throttle_refund(cfg: PolicyConfig, deficit, gcls, k: int, p50,
                     throttled):
    """A 429 blocked a release the allocation layer charged for: credit
    it back like a defer/reject refund (ADRR only)."""
    if cfg.alloc_mode != ALLOC_ADRR:
        return deficit
    karange = torch.arange(k, dtype=torch.int32, device=gcls.device)
    return refund_deficit(deficit, sum32(
        (gcls[:, None] == karange).float() * p50[:, None]
        * throttled[:, None].float(), dim=0))


def _grant_service(phys: ProviderPhysics, batch: RequestBatch,
                   state: SimState, d: BatchDecision, safe, comfort_scale,
                   fleet: Fleet | None, ep, admit0):
    """Each grant's service time before jitter, at the load it saw.  In
    fleet mode at P > 1 the grant gathers its endpoint's physics, and
    its load is that endpoint's outstanding count plus the earlier
    same-endpoint admits of this batch (bounced ones too: the client
    sees a 429 only after the send); at P == 1 the gathers are scalar
    and the load is the global one, as without a fleet."""
    tokens = take(batch.true_tokens, safe)
    inflight = d.inflight_at
    if fleet is not None:
        p = fleet.phys.base_ms.shape[0]
        if p == 1:
            phys = ProviderPhysics(*(a[0] for a in fleet.phys))
            comfort_scale = (None if comfort_scale is None
                             else comfort_scale[0])
        else:
            phys = ProviderPhysics(*(take(a, ep) for a in fleet.phys))
            comfort_scale = take(comfort_scale, ep)
            ep_oh = (ep[:, None] == torch.arange(
                p, dtype=torch.int32, device=ep.device)).to(torch.int32)
            adm_oh = ep_oh * admit0[:, None].to(torch.int32)
            prior = torch.cumsum(adm_oh, 0, dtype=torch.int32) - adm_oh
            inflight = take(state.fleet.inflight, ep) + (
                prior * ep_oh).sum(dim=1, dtype=torch.int32)
    return unloaded_latency_ms(phys, tokens) * load_multiplier(
        phys, inflight, comfort_scale)


def _apply_batch(cfg: PolicyConfig, phys: ProviderPhysics,
                 batch: RequestBatch, jitter: torch.Tensor, state: SimState,
                 d: BatchDecision, comfort_scale=None,
                 limiter: ProviderDynamics | None = None,
                 fleet: Fleet | None = None) -> SimState:
    """State transition for up to B grants as one set of scatters.
    Grants target distinct requests, so the scatters never collide;
    idle rows are dropped.  `comfort_scale` is this tick's brownout value
    ((P,) in fleet mode; None = stationary); `limiter` turns on the token
    bucket: the g-th admit of a class this batch goes through iff its
    bucket holds g grants (later grants were still decided against the
    optimistic inflight count, as a real client only sees the bounce
    after the send).  `fleet` (never with `limiter`) lands each grant on
    its `d.provider_idx` endpoint, whose (endpoint, class) bucket of the
    (P, K) grid it draws from when the fleet has a limiter."""
    n = batch.n
    req = state.req
    provider = state.provider
    fstate = state.fleet
    now = state.now_ms
    admit = d.actions == olc.ADMIT
    defer = d.actions == olc.DEFER
    reject = d.actions == olc.REJECT
    idx = d.req_idx
    safe = torch.clamp(idx, 0, n - 1)  # idle rows may carry the sentinel n
    deficit = d.deficit
    throttled = retry = None
    if limiter is not None:
        k = provider.tb_tokens.shape[0]
        gcls = torch.clamp(take(batch.cls, safe), 0, k - 1)
        key_admit, rank = _bucket_ranks(gcls, k, admit)
        allowed = rank.float() <= take(provider.tb_tokens, gcls) + 1e-6
        throttled = admit & ~allowed
        admit = admit & allowed
        consumed = (key_admit & admit[:, None]).sum(dim=0).float()
        provider = provider._replace(
            tb_tokens=provider.tb_tokens - consumed,
            n_throttled=provider.n_throttled + throttled.sum(
                dtype=torch.int32))
        deficit = _throttle_refund(cfg, deficit, gcls, k,
                                   take(batch.p50, safe), throttled)
        retry = limiter.retry_after_ms

    ep = p_arange = None
    admit0 = admit   # before the fleet's bounces: the load grants saw
    if fleet is not None:
        p = fleet.phys.base_ms.shape[0]
        ep = torch.clamp(d.provider_idx, 0, p - 1)
        p_arange = torch.arange(p, dtype=torch.int32, device=ep.device)
        if fleet.dyn is not None and fleet.dyn.tb_refill is not None:
            # the single-provider rank rule over the flattened (P*K,)
            # bucket keys
            k = fstate.tb_tokens.shape[1]
            gcls = torch.clamp(take(batch.cls, safe), 0, k - 1)
            keys = ep * k + gcls
            key_admit, rank = _bucket_ranks(keys, p * k, admit)
            allowed = rank.float() <= take(fstate.tb_tokens.reshape(p * k),
                                           keys) + 1e-6
            throttled = admit & ~allowed
            admit = admit & allowed
            consumed = (key_admit & admit[:, None]).sum(dim=0).float()
            fstate = fstate._replace(
                tb_tokens=fstate.tb_tokens - consumed.reshape(p, k),
                n_throttled=fstate.n_throttled + (
                    (ep[:, None] == p_arange) & throttled[:, None]).sum(
                    dim=0, dtype=torch.int32))
            provider = provider._replace(
                n_throttled=provider.n_throttled + throttled.sum(
                    dtype=torch.int32))
            deficit = _throttle_refund(cfg, deficit, gcls, k,
                                       take(batch.p50, safe), throttled)
            retry = fleet.dyn.retry_after_ms

    # per-grant service at the load the grant saw.  XLA:CPU contracts the
    # reference's trailing `service * jitter + now` into an FMA; fma32
    # rounds that step once, identically on the CPU and CUDA.
    base = _grant_service(phys, batch, state, d, safe, comfort_scale, fleet,
                          ep, admit0)
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
                                (now + retry).expand(idx.shape), throttled)
        n_throttles = _set_drop(n_throttles, idx, 1, throttled,
                                accumulate=True)
    endpoint = req.endpoint
    if fleet is not None:
        # where each admit went: the failover requeue and the recount
        # read it
        endpoint = _set_drop(endpoint, idx, ep, admit)
        adm_oh = (ep[:, None] == p_arange) & admit[:, None]
        fstate = fstate._replace(
            inflight=fstate.inflight + adm_oh.sum(dim=0, dtype=torch.int32),
            inflight_tokens=fstate.inflight_tokens + sum32(torch.where(
                adm_oh, take(batch.p50, safe)[:, None], 0.0), dim=0))
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
            endpoint=endpoint,
        ),
        sched=state.sched._replace(deficit=deficit, rr_turn=d.rr_turn),
        provider=provider._replace(
            inflight=provider.inflight + admitted,
            inflight_tokens=provider.inflight_tokens + sum32(
                torch.where(admit, take(batch.p50, safe), 0.0)),
        ),
        fleet=fstate,
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
    win_req = RequestState(*(None if f is None else f.index_select(0, safe)
                             for f in req))
    win_req = win_req._replace(
        status=torch.where(occ, win_req.status, REJECTED).to(torch.int32),
        finish_ms=torch.where(occ, win_req.finish_ms, float("inf")),
    )
    return win_batch, win_req, occ


def _retire_window(cfg, phys, batch, state: SimState, win: WindowCarry,
                   avail_t=None, retry_after_ms=None):
    """Windowed completion/timeout/stale pass: the dense transition on the
    (W,) view, then a scatter of the updated statuses into the dense
    arrays (and, after a failover requeue, of the reset finish times,
    defers and throttle counts).  Returns (state, alive) with alive
    marking slots still PENDING or INFLIGHT."""
    win_batch, win_req, occ = _window_view(batch, state.req, win.slot_req)
    win_state = _complete_and_timeout(cfg, phys, win_batch,
                                      state._replace(req=win_req),
                                      avail_t=avail_t,
                                      retry_after_ms=retry_after_ms)
    status_w = win_state.req.status
    req = state.req
    if avail_t is not None:
        req = req._replace(**{
            f: _set_drop(getattr(req, f), win.slot_req,
                         getattr(win_state.req, f), occ)
            for f in ("finish_ms", "defer_until", "n_throttles")})
    state = state._replace(
        req=req._replace(status=_set_drop(req.status, win.slot_req, status_w,
                                          occ)),
        sched=win_state.sched,
        provider=win_state.provider,
        fleet=win_state.fleet,
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
             limiter: ProviderDynamics | None = None,
             fleet: Fleet | None = None, avail_t=None):
    """One decision epoch: retire -> compact + admit -> limiter refill ->
    route -> dispatch -> apply.  `win=None` runs the dense O(N)
    transition; a `WindowCarry` runs the O(W) active-window path.
    `comfort_t` is the tick's brownout value, `refill_t` its bucket
    refill and `limiter` the dynamics holding the buckets' capacity and
    Retry-After (each None when off).  With `fleet` the rows are the
    per-endpoint ones ((P,), (P, K)) and `avail_t` is the tick's (P,)
    availability.  Returns (state, win, ys) with ys the tick's
    decision-trace row (actions, global req_idx, severity) or None."""
    state = state._replace(now_ms=now_ms)
    fl_dyn = fleet.dyn if fleet is not None else None
    fleet_limited = fl_dyn is not None and fl_dyn.tb_refill is not None
    retry = fl_dyn.retry_after_ms if avail_t is not None else None
    if win is not None:
        state, alive = _retire_window(policy, phys, batch, state, win,
                                      avail_t=avail_t, retry_after_ms=retry)
        win = _compact_and_admit(batch, win, alive, now_ms)
    else:
        state = _complete_and_timeout(policy, phys, batch, state,
                                      avail_t=avail_t, retry_after_ms=retry)
    if limiter is not None:
        state = state._replace(provider=state.provider._replace(
            tb_tokens=torch.minimum(state.provider.tb_tokens + refill_t,
                                    limiter.tb_capacity)))
    if fleet_limited:
        state = state._replace(fleet=state.fleet._replace(
            tb_tokens=torch.minimum(state.fleet.tb_tokens + refill_t,
                                    fl_dyn.tb_capacity)))
    if win is not None:
        d_batch, d_req, _ = _window_view(batch, state.req, win.slot_req)
    else:
        d_batch, d_req = batch, state.req
    route = endpoint = None
    if fleet is not None:
        if fleet.phys.base_ms.shape[0] > 1:
            endpoint, route = route_requests(
                fleet.phys, state.fleet, d_batch.p50, comfort_t=comfort_t,
                avail_t=avail_t,
                retry_after_ms=fl_dyn.retry_after_ms if fleet_limited
                else None)
        else:
            # one endpoint: no choice to make and no route term, so the
            # ordering is the single-provider program
            endpoint = torch.zeros(d_batch.p50.shape, dtype=torch.int32,
                                   device=now_ms.device)
    d = schedule_batch(policy, d_batch, state._replace(req=d_req),
                       max_grants=k_slots, backend=backend, route=route,
                       endpoint=endpoint)
    if win is not None:
        # slot-local decision -> global request ids (empty slots map to
        # the sentinel n, which only idle rows can carry); provider_idx
        # is already an endpoint
        w = win.slot_req.shape[0]
        d = d._replace(
            req_idx=take(win.slot_req, torch.clamp(d.req_idx, 0, w - 1)))
    state = _apply_batch(policy, phys, batch, jitter, state, d,
                         comfort_scale=comfort_t, limiter=limiter,
                         fleet=fleet)
    ys = (d.actions, d.req_idx, d.severity) if collect_decisions else None
    return state, win, ys


def run_sim(policy: PolicyConfig, batch: RequestBatch, jitter: torch.Tensor,
            phys: ProviderPhysics, sim_cfg: SimConfig = SimConfig(),
            dynamics: ProviderDynamics | None = None,
            collect_decisions: bool = False, fleet: Fleet | None = None, *,
            device="cuda", on_tick=None):
    """Run the full horizon on `device`; returns the final SimState, or
    (final, (actions (T,B), req_idx (T,B), severity (T,))) with
    `collect_decisions=True` (req_idx in global request ids on both
    engines).  `dynamics` adds the provider's per-tick schedules (each
    at least `sim_cfg.n_ticks` long); the token buckets start full.
    `fleet` (never with `dynamics`) runs P endpoints, with
    `SimState.fleet` carrying the per-endpoint split and
    `RequestState.endpoint` each request's last endpoint.  Windowed mode
    needs `batch.arrival_ms` sorted ascending (the generator's native
    order).  `on_tick(t, state, win)`, when given, is called after every
    tick (win is None on the dense path) and must not modify what it is
    handed."""
    if fleet is not None and dynamics is not None:
        raise ValueError(
            "fleet and dynamics are mutually exclusive: use "
            "FleetDynamics for per-endpoint schedules")
    dev = resolve_device(device)
    policy, phys, batch, jitter, dynamics, fleet = to_device(
        (policy, phys, batch, jitter, dynamics, fleet), dev)
    n = batch.n
    k = n_classes(policy)
    state = init_sim_state(n, k, dev)
    comfort = dynamics.comfort_scale if dynamics is not None else None
    limiter = (dynamics if dynamics is not None
               and dynamics.tb_refill is not None else None)
    refill = limiter.tb_refill if limiter is not None else None
    avail = None
    if limiter is not None:
        state = state._replace(provider=state.provider._replace(
            tb_tokens=limiter.tb_capacity))
    if fleet is not None:
        fstate = init_fleet_state(fleet.phys.base_ms.shape[0], k, dev)
        fl_dyn = fleet.dyn
        if fl_dyn is not None:
            comfort, refill, avail = (fl_dyn.comfort_scale, fl_dyn.tb_refill,
                                      fl_dyn.avail)
            if refill is not None:
                fstate = fstate._replace(tb_tokens=fl_dyn.tb_capacity)
        state = state._replace(
            req=state.req._replace(
                endpoint=torch.zeros((n,), dtype=torch.int32, device=dev)),
            fleet=fstate)
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
            refill_t=None if refill is None else refill[t],
            limiter=limiter, fleet=fleet,
            avail_t=None if avail is None else avail[t])
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
