"""Layer 3 — overload control (paper §3.1.3).

Counterpart of `repro.core.overload`.  Severity integrates only
client-observable signals,

    severity = w_load * provider_load + w_queue * queue_pressure
             + w_tail * tail_latency_ratio,

and the admission decision maps it through per-bucket threshold tables
(inf = never).  Actions:  0 = admit,  1 = defer,  2 = reject.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import pinned
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.types import take

ADMIT, DEFER, REJECT = 0, 1, 2


def severity_score(
    cfg: PolicyConfig,
    *,
    inflight_total: torch.Tensor,     # () int
    n_pending: torch.Tensor,          # () int
    ema_latency_ratio: torch.Tensor,  # () float32
) -> torch.Tensor:
    provider_load = inflight_total.float() / torch.clamp(cfg.load_ref, min=1.0)
    queue_pressure = n_pending.float() / torch.clamp(cfg.queue_ref, min=1.0)
    tail_ratio = (torch.clamp(ema_latency_ratio, min=1.0) - 1.0) / torch.clamp(
        cfg.tail_ref - 1.0, min=1e-3)
    # each term rounds on its own before the sum, as in the reference
    terms = pinned((
        cfg.olc_w_load * torch.clamp(provider_load, max=2.0),
        cfg.olc_w_queue * torch.clamp(queue_pressure, max=2.0),
        cfg.olc_w_tail * torch.clamp(tail_ratio, max=2.0),
    ))
    return torch.clamp((terms[0] + terms[1]) + terms[2], min=0.0)


def admission_action(
    cfg: PolicyConfig,
    *,
    severity: torch.Tensor,  # () float32
    bucket: torch.Tensor,    # () or (B,) int candidate's bucket
    n_defers: torch.Tensor,  # same shape, times already deferred
) -> torch.Tensor:
    """Cost-ladder decision: REJECT dominates DEFER; after `max_defers`
    deferrals a request that would only be deferred is admitted."""
    over_defer = severity > take(cfg.defer_thr, bucket)
    over_reject = severity > take(cfg.reject_thr, bucket)
    defer_exhausted = n_defers.float() >= cfg.max_defers
    action = torch.where(
        over_reject, REJECT,
        torch.where(over_defer & ~defer_exhausted, DEFER, ADMIT))
    return torch.where(cfg.olc_enabled > 0, action, ADMIT).to(torch.int32)


def defer_backoff(cfg: PolicyConfig, severity, n_defers) -> torch.Tensor:
    """Backoff grows with severity and with repeat deferrals."""
    growth = 1.0 + 0.5 * n_defers.float()
    return cfg.defer_backoff_ms * (0.5 + severity) * growth
