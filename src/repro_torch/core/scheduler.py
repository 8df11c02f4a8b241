"""The fused three-layer client scheduler (paper §3), K classes.

Counterpart of `repro.core.scheduler`.  `schedule_slot` composes the
layers once: allocation picks a class, ordering names its request, the
overload layer may block or delay it.  `schedule_batch` grants up to B
releases per decision epoch in one pass; with `max_grants=1` it makes
`schedule_slot`'s decision.  The O(K·N) work —
eligibility, the ranked top-B candidates per class and the global FIFO
lane, one severity evaluation — runs up front; the grant loop then
replays only the O(K) allocation step per grant.  Severity is frozen
across the B grants, while DRR deficits, per-class and global inflight
caps and the FQ pointer update per grant.

In fleet mode `schedule_batch` takes the route term and each request's
endpoint from `routing.route_requests`: the route joins the scored
ordering, and each grant's endpoint is gathered into
`BatchDecision.provider_idx`.  Routing sits above allocation, so the
three paper layers are unchanged.

The reference's `lax.fori_loop` over the grants is a Python loop of at
most B iterations over (K,)-sized tensors.  Nothing in it reads a value
back to the host, so the loop only enqueues device work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import drr, ordering, overload
from repro_torch.core.policy import ALLOC_ADRR, PolicyConfig, n_classes
from repro_torch.core.types import INFLIGHT, RequestBatch, SimState, take

IDLE = -1


class SlotDecision(NamedTuple):
    action: torch.Tensor   # () int32: -1 idle, 0 admit, 1 defer, 2 reject
    req_idx: torch.Tensor  # () int32 target request (valid iff action>=0)
    severity: torch.Tensor  # () float32 overload severity used
    deficit: torch.Tensor  # (K,) float32 updated allocation deficits
    rr_turn: torch.Tensor  # () int32 updated FQ pointer


class BatchDecision(NamedTuple):
    """Up to B grants; row g is the g-th grant in decision order, and
    rows with action == IDLE carry no release."""

    actions: torch.Tensor      # (B,) int32: -1 idle, 0 admit, 1 defer, 2 reject
    req_idx: torch.Tensor      # (B,) int32 target request (valid iff action>=0)
    inflight_at: torch.Tensor  # (B,) int32 inflight total seen by grant g
    severity: torch.Tensor     # () float32 severity shared by all B decisions
    deficit: torch.Tensor      # (K,) float32 updated allocation deficits
    rr_turn: torch.Tensor      # () int32 updated FQ pointer
    # (B,) int32 fleet endpoint per grant; None outside fleet mode
    provider_idx: Optional[torch.Tensor] = None


def effective_class(cfg: PolicyConfig, batch: RequestBatch) -> torch.Tensor:
    """Info ladder: without class routing every request shares lane 0;
    class ids are clipped into [0, K)."""
    cls = torch.clamp(batch.cls, 0, n_classes(cfg) - 1)
    return torch.where(cfg.route_by_class > 0, cls, 0).to(torch.int32)


def _refund(cfg, k, cls_id, head_cost, action, ignore_class: bool):
    """Deficit conservation: credit back the head cost DRR charged when
    the overload layer blocked the release.  Only ADRR charges, so
    other modes (and the naive lane) get no refund."""
    if ignore_class or cfg.alloc_mode != ALLOC_ADRR:
        return None
    onehot = (torch.arange(k, device=head_cost.device) == cls_id).float()
    blocked = (action == overload.DEFER) | (action == overload.REJECT)
    return onehot * take(head_cost, cls_id) * blocked.float()


def refund_deficit(deficit, refund):
    """`deficit + refund` where every entry stays finite, else `deficit`
    (None: no refund)."""
    if refund is None:
        return deficit
    return torch.where(torch.isfinite(deficit + refund), deficit + refund,
                       deficit)


def charge_resubmit(cfg: PolicyConfig, deficit: torch.Tensor,
                    charge: torch.Tensor) -> torch.Tensor:
    """Debit resubmission traffic (the (K,) per-class p50 cost sent again
    this epoch) against the class deficits, so that retries do not ride
    for free.  Only ADRR charges deficits; with no charge, or a debit
    that is not finite, `deficit` comes back unchanged in its bits (x -
    0.0 is not an identity at -0.0)."""
    if cfg.alloc_mode != ALLOC_ADRR:
        return deficit
    debited = deficit - charge
    return torch.where((charge > 0.0).any() & torch.isfinite(debited).all(),
                       debited, deficit)


def schedule_slot(cfg: PolicyConfig, batch: RequestBatch, state: SimState
                  ) -> SlotDecision:
    """One send opportunity: allocation -> ordering -> overload."""
    k = n_classes(cfg)
    i32 = torch.int32
    now = state.now_ms
    elig = ordering.eligibility(batch, state.req.status,
                                state.req.defer_until, now)
    eff_cls = effective_class(cfg, batch)
    karange = torch.arange(k, dtype=i32, device=elig.device)
    cls_onehot = eff_cls[None, :] == karange[:, None]
    elig_kn = cls_onehot & elig[None, :]

    # layer 2 first per class: allocation tests each head's cost
    cand_idx, cand_ok = ordering.select_per_class(batch, elig_kn, now, cfg)
    head_cost = torch.where(cand_ok, take(batch.p50, cand_idx), float("inf"))
    inflight_cls = (cls_onehot & (state.req.status == INFLIGHT)[None, :]).sum(
        dim=1, dtype=i32)
    sev = overload.severity_score(
        cfg,
        inflight_total=state.provider.inflight,
        n_pending=elig.sum(dtype=i32),
        ema_latency_ratio=state.sched.ema_latency_ratio,
    )
    choice = drr.allocate(
        cfg,
        backlog=elig_kn.sum(dim=1, dtype=i32),
        head_cost=head_cost,
        inflight_cls=inflight_cls,
        inflight_total=state.provider.inflight,
        severity=sev,
        deficit=state.sched.deficit,
        rr_turn=state.sched.rr_turn,
    )
    if choice.ignore_class:
        # naive mode ignores lanes: the global FIFO head
        fifo_idx, n_elig = ordering.rank_fifo(batch, elig, 1)
        idx, ok = fifo_idx[0], n_elig > 0
    else:
        idx, ok = take(cand_idx, choice.cls_id), take(cand_ok, choice.cls_id)
    ok = ok & choice.send_ok
    act = overload.admission_action(
        cfg,
        severity=sev,
        bucket=take(batch.bucket, idx),
        n_defers=take(state.req.n_defers, idx),
    )
    action = torch.where(ok, act, IDLE).to(i32)
    refund = _refund(cfg, k, choice.cls_id, head_cost, action,
                     choice.ignore_class)
    return SlotDecision(
        action=action,
        req_idx=idx.to(i32),
        severity=sev,
        deficit=refund_deficit(choice.deficit, refund),
        rr_turn=choice.rr_turn,
    )


def schedule_batch(
    cfg: PolicyConfig,
    batch: RequestBatch,
    state: SimState,
    max_grants: int = 1,
    backend: str = "torch",
    route=None,
    endpoint=None,
) -> BatchDecision:
    """Grant up to `max_grants` releases in one pass (see module doc).
    `route` ((N,) float32) and `endpoint` ((N,) int32) are the fleet's
    route term and best endpoints; passing neither is the
    single-provider program."""
    k = n_classes(cfg)
    bmax = min(int(max_grants), batch.n)
    dev = batch.arrival_ms.device
    i32 = torch.int32
    now = state.now_ms
    elig = ordering.eligibility(batch, state.req.status,
                                state.req.defer_until, now)
    eff_cls = effective_class(cfg, batch)
    karange = torch.arange(k, dtype=i32, device=dev)
    cls_onehot = eff_cls[None, :] == karange[:, None]
    elig_kn = cls_onehot & elig[None, :]

    # layer 2 once: ranked candidates per class + the global FIFO lane
    rank_idx, n_elig_cls = ordering.select_top_b(
        batch, elig_kn, now, cfg, bmax, backend=backend, route=route)
    glob_idx, n_elig_tot = ordering.rank_fifo(batch, elig, bmax,
                                              backend=backend)
    # int64 inside the grant loop: indices are cast once, here
    rank_idx, glob_idx = rank_idx.long(), glob_idx.long()
    visible_cls = torch.clamp(n_elig_cls, max=bmax)
    visible_glob = torch.clamp(n_elig_tot, max=bmax)
    inflight_cls = (cls_onehot & (state.req.status == INFLIGHT)[None, :]).sum(
        dim=1, dtype=i32)

    # layer 3 once: one severity drives all B ladder decisions
    sev = overload.severity_score(
        cfg,
        inflight_total=state.provider.inflight,
        n_pending=n_elig_tot,
        ema_latency_ratio=state.sched.ema_latency_ratio,
    )

    deficit = state.sched.deficit
    rr_turn = state.sched.rr_turn
    infl_tot = state.provider.inflight
    cls_ptr = torch.zeros((k,), dtype=i32, device=dev)
    glob_ptr = torch.zeros((), dtype=i32, device=dev)
    actions, idxs, infl_at = [], [], []
    for _ in range(bmax):
        # per-class heads at the current rank pointers
        col = torch.clamp(cls_ptr, 0, bmax - 1).long()
        head_idx = rank_idx.gather(1, col[:, None])[:, 0]
        ok_c = cls_ptr < visible_cls
        head_cost = torch.where(ok_c, take(batch.p50, head_idx),
                                float("inf"))
        choice = drr.allocate(
            cfg,
            backlog=visible_cls - cls_ptr,
            head_cost=head_cost,
            inflight_cls=inflight_cls,
            inflight_total=infl_tot,
            severity=sev,
            deficit=deficit,
            rr_turn=rr_turn,
        )
        if choice.ignore_class:
            idx = take(glob_idx, torch.clamp(glob_ptr, 0, bmax - 1))
            ok = glob_ptr < visible_glob
        else:
            idx = take(head_idx, choice.cls_id)
            ok = take(ok_c, choice.cls_id)
        ok = ok & choice.send_ok

        act = overload.admission_action(
            cfg,
            severity=sev,
            bucket=take(batch.bucket, idx),
            n_defers=take(state.req.n_defers, idx),
        )
        action = torch.where(ok, act, IDLE).to(i32)

        refund = _refund(cfg, k, choice.cls_id, head_cost, action,
                         choice.ignore_class)
        deficit = refund_deficit(choice.deficit, refund)
        rr_turn = choice.rr_turn

        # cumulative bookkeeping for the next grant: a live decision
        # consumes its candidate; only admits hold provider slots
        live = (action != IDLE).to(i32)
        admit = (action == overload.ADMIT).to(i32)
        cls_take = (karange == take(eff_cls, idx)).to(i32) * live
        infl_at.append(infl_tot)
        inflight_cls = inflight_cls + cls_take * admit
        infl_tot = infl_tot + admit
        if choice.ignore_class:
            glob_ptr = glob_ptr + live
        else:
            cls_ptr = cls_ptr + cls_take
        actions.append(action)
        idxs.append(idx)

    req_idx = torch.stack(idxs).to(i32)
    # the endpoint was fixed before allocation: granting only gathers it
    provider_idx = None if endpoint is None else take(
        endpoint, torch.clamp(req_idx, 0, batch.n - 1)).to(i32)
    return BatchDecision(
        actions=torch.stack(actions),
        req_idx=req_idx,
        inflight_at=torch.stack(infl_at).to(i32),
        severity=sev,
        deficit=deficit,
        rr_turn=rr_turn,
        provider_idx=provider_idx,
    )
