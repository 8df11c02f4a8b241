"""Layer 1 — allocation (paper §3.1.1), K classes.

Counterpart of `repro.core.drr`: adaptive deficit round robin over K
service classes plus the paper's alternatives (naive FIFO, quota-tiered
isolation, fair queuing, strict priority).  One dispatch slot at a time:

  * each backlogged class accrues `quantum * w_eff` deficit per slot;
  * a class may send iff its deficit covers its head request's cost;
  * idle classes' quanta are lent to backlogged ones in proportion to
    their effective weights (work conservation);
  * protected classes scale their weight by (1 + kappa * severity) and
    keep their inflight cap while unprotected caps shrink.

The mode is a Python int, so only the chosen branch runs (the reference
`lax.switch`es over all five).  Small float sums over the class axis are
taken in float64 and rounded once, so the CPU and CUDA agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.numerics import sum32
from repro_torch.core.policy import (
    ALLOC_ADRR,
    ALLOC_FQ,
    ALLOC_NAIVE,
    PolicyConfig,
)
from repro_torch.core.types import take


class ClassChoice(NamedTuple):
    cls_id: torch.Tensor      # () int64 selected class (valid iff send_ok)
    send_ok: torch.Tensor     # () bool a release is allowed this slot
    ignore_class: bool        # pick the request globally (naive lane)
    deficit: torch.Tensor     # (K,) float32 updated deficit counters
    rr_turn: torch.Tensor     # () int32 updated round-robin pointer


def effective_weights(cfg: PolicyConfig, severity) -> torch.Tensor:
    """Congestion-aware weights: protected share grows with severity."""
    return cfg.drr_weights * (
        1.0 + cfg.congestion_kappa * severity * cfg.class_protect)


def allocate(
    cfg: PolicyConfig,
    *,
    backlog: torch.Tensor,         # (K,) int eligible count per class
    head_cost: torch.Tensor,       # (K,) float32 p50 of each class's pick
    inflight_cls: torch.Tensor,    # (K,) int in-flight count per class
    inflight_total: torch.Tensor,  # () int
    severity: torch.Tensor,        # () float32
    deficit: torch.Tensor,         # (K,) float32
    rr_turn: torch.Tensor,         # () int32
) -> ClassChoice:
    k = deficit.shape[-1]
    i32 = torch.int32
    under_cap = inflight_total < cfg.max_inflight
    shrink = torch.clamp(
        1.0 - cfg.cap_kappa * torch.clamp(severity, max=1.2), min=0.3)
    cap_eff = cfg.class_cap * torch.where(cfg.class_protect > 0, 1.0, shrink)
    cap_eff = torch.clamp(cap_eff, min=1.0)
    has_work = (backlog > 0) & (inflight_cls < cap_eff)
    any_work = has_work.any()
    mode = min(max(int(cfg.alloc_mode), 0), 4)

    if mode == ALLOC_NAIVE:
        # single lane, admit-all order of arrival; no deficit bookkeeping
        return ClassChoice(
            cls_id=torch.zeros((), dtype=torch.int64, device=deficit.device),
            send_ok=(backlog > 0).any() & under_cap,
            ignore_class=True, deficit=deficit, rr_turn=rr_turn)

    if mode == ALLOC_ADRR:
        w_eff = effective_weights(cfg, severity)
        work = has_work.float()
        accrue = cfg.drr_quantum * w_eff * work
        idle_quota = sum32(cfg.drr_quantum * w_eff * (1.0 - work))
        w_backlogged = w_eff * work
        denom = sum32(w_backlogged)
        share = torch.where(denom > 0, w_backlogged / denom, 0.0)
        d = torch.minimum(deficit + accrue + idle_quota * share,
                          cfg.deficit_cap)
        affordable = has_work & (d >= torch.minimum(head_cost,
                                                    cfg.deficit_cap))
        pref = torch.where(
            affordable, d * cfg.drr_weights / sum32(cfg.drr_weights),
            float("-inf"))
        cls_id = torch.argmax(pref)
        ok = affordable.any() & under_cap
        onehot = torch.arange(k, device=deficit.device) == cls_id
        d = torch.where(ok, d - onehot.float() * take(head_cost, cls_id), d)
        # deficits of idle classes reset (classic DRR drops state when empty)
        d = torch.where(has_work, d, 0.0)
        return ClassChoice(cls_id=cls_id, send_ok=ok,
                           ignore_class=False, deficit=d, rr_turn=rr_turn)

    if mode == ALLOC_FQ:
        # strict round robin: first backlogged class in rotation order
        offsets = (rr_turn + torch.arange(k, device=deficit.device)) % k
        cls_id = take(offsets, torch.argmax(take(has_work, offsets).to(i32)))
        ok = any_work & under_cap
        turn = torch.where(ok, (cls_id + 1) % k, rr_turn)
        return ClassChoice(cls_id=cls_id, send_ok=ok,
                           ignore_class=False, deficit=deficit,
                           rr_turn=turn.to(i32))

    # ALLOC_QUOTA (strict silos, lowest class first) and ALLOC_SP
    # (strict priority) pick the same class: the first with work
    cls_id = torch.argmax(has_work.to(i32))
    return ClassChoice(cls_id=cls_id, send_ok=any_work & under_cap,
                       ignore_class=False, deficit=deficit, rr_turn=rr_turn)
