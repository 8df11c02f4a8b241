"""PolicyConfig: one struct that covers every named strategy.

Counterpart of `repro.core.policy`.  The named strategies:

  direct_naive    alloc_mode=NAIVE, overload off, FIFO ordering
  quota_tiered    alloc_mode=QUOTA, per-class inflight quotas, no borrowing
  adaptive_drr    alloc_mode=ADRR, ordering on, overload off
  final_adrr_olc  alloc_mode=ADRR, ordering on, overload cost ladder
  fair_queuing    alloc_mode=FQ (strict round-robin between classes)
  short_priority  alloc_mode=SP (interactive class strictly first)

Overload `bucket_policy` shapes (paper §4.7) are the per-bucket
threshold tables `defer_thr` / `reject_thr` (inf = never); see
`with_bucket_policy`.  `with_information` is the policy-side part of
the information ladder (paper §4.4); `per_bucket_policy` and
`multi_tenant_policy` make the 4-lane and K-tenant policies.

Every field is a float32 tensor except `alloc_mode`, which stays a
Python int: the allocation layer branches on it in Python, so a tick
needs no host sync to pick its mode (the reference `lax.switch`es on a
traced scalar).  Builders make CPU tensors; the simulator moves a
config to the device it runs on (`repro_torch.device.to_device`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import NEVER

# Allocation modes
ALLOC_NAIVE = 0     # single FIFO lane, admit-all
ALLOC_QUOTA = 1     # tiered isolation: per-class inflight quotas, no borrow
ALLOC_ADRR = 2      # adaptive deficit round robin (the paper's allocation)
ALLOC_FQ = 3        # fair queuing: strict round-robin across classes
ALLOC_SP = 4        # short-priority: interactive strictly first


class PolicyConfig(NamedTuple):
    """Per-class arrays share one length K; `n_classes(cfg)` reads it."""

    # --- allocation (layer 1) ---
    alloc_mode: int                  # one of ALLOC_*
    drr_quantum: torch.Tensor        # () tokens added per backlogged turn
    drr_weights: torch.Tensor        # (K,) base class weights
    congestion_kappa: torch.Tensor   # () protected-weight scaling vs severity
    deficit_cap: torch.Tensor        # () max deficit (anti-burst)
    class_cap: torch.Tensor          # (K,) per-class inflight caps
    cap_kappa: torch.Tensor          # () severity shrink of unprotected caps
    class_protect: torch.Tensor      # (K,) 0/1 protected lanes
    max_inflight: torch.Tensor       # () client-wide concurrency cap
    load_ref: torch.Tensor           # () severity normalizer for load

    # --- ordering (layer 2) ---
    ord_scored: torch.Tensor         # (K,) 0/1 scored rule per class
    ord_w_wait: torch.Tensor         # () weight on wait/cost
    ord_w_size: torch.Tensor         # () weight on size/ref (penalty)
    ord_w_urg: torch.Tensor          # () weight on deadline urgency
    ord_ref_tokens: torch.Tensor     # () size normalizer
    ord_w_route: torch.Tensor        # () weight on the fleet route term

    # --- overload control (layer 3) ---
    olc_enabled: torch.Tensor        # () 0/1
    olc_w_load: torch.Tensor         # ()
    olc_w_queue: torch.Tensor        # ()
    olc_w_tail: torch.Tensor         # ()
    defer_thr: torch.Tensor          # (4,) per-bucket severity cutoffs
    reject_thr: torch.Tensor         # (4,) per-bucket severity cutoffs
    defer_backoff_ms: torch.Tensor   # () base re-eligibility delay
    max_defers: torch.Tensor         # () defers before forced decision
    queue_ref: torch.Tensor          # () queue-pressure normalizer
    tail_ref: torch.Tensor           # () tail-ratio normalizer

    # --- misc ---
    route_by_class: torch.Tensor     # () 0/1 info-ladder class routing
    timeout_mult: torch.Tensor       # (4,) per-bucket patience multiplier


def _f(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def n_classes(cfg: PolicyConfig) -> int:
    """Static class count K carried by the per-class policy arrays."""
    return cfg.drr_weights.shape[-1]


DEFAULT_MAX_INFLIGHT = 20.0


def base_policy(**overrides) -> PolicyConfig:
    """The Final (OLC) configuration — paper defaults."""
    cfg = dict(
        alloc_mode=ALLOC_ADRR,
        drr_quantum=_f(220.0),
        drr_weights=_f([2.0, 1.0]),
        congestion_kappa=_f(1.5),
        deficit_cap=_f(8000.0),
        class_cap=_f([16.0, 4.0]),
        cap_kappa=_f(0.5),
        class_protect=_f([1.0, 0.0]),
        max_inflight=_f(DEFAULT_MAX_INFLIGHT),
        load_ref=_f(6.0),
        ord_scored=_f([0.0, 1.0]),
        ord_w_wait=_f(1.0),
        ord_w_size=_f(0.6),
        ord_w_urg=_f(0.8),
        ord_ref_tokens=_f(512.0),
        ord_w_route=_f(1.0),
        olc_enabled=_f(1.0),
        olc_w_load=_f(0.40),
        olc_w_queue=_f(0.30),
        olc_w_tail=_f(0.30),
        defer_thr=_f([NEVER, NEVER, 0.45, 0.45]),
        reject_thr=_f([NEVER, NEVER, 0.80, 0.65]),
        defer_backoff_ms=_f(1000.0),
        max_defers=_f(2.0),
        queue_ref=_f(40.0),
        tail_ref=_f(4.0),
        route_by_class=_f(1.0),
        timeout_mult=_f([3.0, 3.0, 3.0, 3.0]),
    )
    cfg.update(overrides)
    return PolicyConfig(**cfg)


# ---------------------------------------------------------------------------
# Named strategies (paper §4.5/§4.6)
# ---------------------------------------------------------------------------

def direct_naive() -> PolicyConfig:
    return base_policy(
        alloc_mode=ALLOC_NAIVE,
        olc_enabled=_f(0.0),
        ord_w_size=_f(0.0),
        ord_w_urg=_f(0.0),
        route_by_class=_f(0.0),
        class_cap=_f([1e9, 1e9]),
        max_inflight=_f(1e9),
    )


def quota_tiered() -> PolicyConfig:
    return base_policy(
        alloc_mode=ALLOC_QUOTA,
        olc_enabled=_f(0.0),
        class_cap=_f([8.0, 3.0]),
        cap_kappa=_f(0.0),
        timeout_mult=_f([3.0, 3.0, 2.0, 0.45]),
    )


def adaptive_drr() -> PolicyConfig:
    return base_policy(olc_enabled=_f(0.0))


def final_adrr_olc() -> PolicyConfig:
    return base_policy()


def fair_queuing() -> PolicyConfig:
    return base_policy(alloc_mode=ALLOC_FQ, olc_enabled=_f(0.0))


def short_priority() -> PolicyConfig:
    return base_policy(alloc_mode=ALLOC_SP, olc_enabled=_f(0.0))


# ---------------------------------------------------------------------------
# Overload bucket_policy shapes (paper §4.7) applied on top of Final (OLC)
# ---------------------------------------------------------------------------

BUCKET_POLICIES = {
    "ladder": ([NEVER, NEVER, 0.45, 0.45], [NEVER, NEVER, 0.80, 0.65]),
    "uniform_mild": ([NEVER, 0.45, 0.45, 0.45], [NEVER] * 4),
    "uniform_harsh": ([NEVER, 0.45, 0.45, 0.45], [NEVER, 0.65, 0.65, 0.65]),
    "reverse": ([NEVER, NEVER, 0.45, 0.45], [NEVER, NEVER, 0.65, 0.80]),
}


def with_bucket_policy(cfg: PolicyConfig, shape: str) -> PolicyConfig:
    """`cfg` with the defer/reject tables of an overload shape; an
    unknown shape raises `KeyError`."""
    d, r = BUCKET_POLICIES[shape]
    return cfg._replace(defer_thr=_f(d), reject_thr=_f(r))


def with_information(cfg: PolicyConfig, level: str) -> PolicyConfig:
    """Information-ladder conditions (paper §4.4), policy side; the
    workload generator owns the priors.  `no_info` runs one neutral lane
    with uniform admission thresholds (the client cannot infer cost from
    labels); the other levels keep `cfg`."""
    if level == "no_info":
        return cfg._replace(
            route_by_class=_f(0.0),
            defer_thr=_f([0.60] * 4),
            reject_thr=_f([0.92] * 4),
        )
    if level in ("class_only", "coarse", "oracle"):
        return cfg
    raise ValueError(f"unknown information level: {level}")


# ---------------------------------------------------------------------------
# K-class policies (beyond-paper scenarios)
# ---------------------------------------------------------------------------

def kclass_policy(
    k: int,
    *,
    weights=None,
    caps=None,
    protect=None,
    scored=None,
    **overrides,
) -> PolicyConfig:
    """Generic K-class policy: seed defaults with (K,)-shaped class arrays
    (uniform weights, evenly split caps, no protected lane, scored
    ordering everywhere unless given)."""
    if k < 1:
        raise ValueError(f"n_classes must be >= 1, got {k}")
    w = _f([1.0] * k) if weights is None else _f(weights)
    mi = overrides.get("max_inflight", DEFAULT_MAX_INFLIGHT)
    budget = float(mi.item() if isinstance(mi, torch.Tensor) else mi)
    default_cap = max(2.0, round(2.0 * budget / k))
    c = _f([default_cap] * k) if caps is None else _f(caps)
    p = _f([0.0] * k) if protect is None else _f(protect)
    s = _f([1.0] * k) if scored is None else _f(scored)
    for name, arr in (("weights", w), ("caps", c), ("protect", p),
                      ("scored", s)):
        if tuple(arr.shape) != (k,):
            raise ValueError(
                f"{name} must have shape ({k},), got {tuple(arr.shape)}")
    return base_policy(
        drr_weights=w, class_cap=c, class_protect=p, ord_scored=s, **overrides
    )


def multi_tenant_policy(k: int, **overrides) -> PolicyConfig:
    """K symmetric tenants: uniform DRR weights, per-tenant inflight caps,
    scored ordering in every lane, no protected lane."""
    return kclass_policy(k, **overrides)


def per_bucket_policy(**overrides) -> PolicyConfig:
    """Four lanes keyed on the token bucket (short/medium/long/xlong):
    the short lane keeps the protected-FIFO role; the other three use
    the scored rule with descending weight."""
    return kclass_policy(
        4,
        weights=[2.0, 1.0, 0.7, 0.4],
        caps=[16.0, 6.0, 4.0, 3.0],
        protect=[1.0, 0.0, 0.0, 0.0],
        scored=[0.0, 1.0, 1.0, 1.0],
        **overrides,
    )


STRATEGIES = {
    "direct_naive": direct_naive,
    "quota_tiered": quota_tiered,
    "adaptive_drr": adaptive_drr,
    "final_adrr_olc": final_adrr_olc,
    "fair_queuing": fair_queuing,
    "short_priority": short_priority,
}


def strategy(name: str) -> PolicyConfig:
    return STRATEGIES[name]()
