"""Joint metrics (paper §4.3), with per-class vectors for K-class runs.

Counterpart of `repro.sim.metrics`: `masked_percentile`, `SimMetrics`
and `compute_metrics`, and the per-phase metrics of a scenario run
(`PhaseMetrics`, `compute_phase_metrics`).
The paper reads these together: short P95, global P95, completion
rate, deadline satisfaction, useful goodput, makespan and the overload
action counts that make shedding legible.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import (
    ABANDONED,
    COMPLETED,
    REJECTED,
    SHORT,
    RequestBatch,
    SimState,
    take,
)


def masked_percentile(values: torch.Tensor, mask: torch.Tensor,
                      q: float) -> torch.Tensor:
    """Nearest-rank percentile of values[mask]; NaN when mask is empty."""
    n = mask.sum()
    s = torch.sort(torch.where(mask, values, float("inf"))).values
    idx = torch.clamp(torch.ceil(q * n).to(torch.int32) - 1, 0,
                      values.shape[0] - 1)
    return torch.where(n > 0, take(s, idx), float("nan"))


class SimMetrics(NamedTuple):
    short_p95_ms: torch.Tensor
    short_p90_ms: torch.Tensor
    long_p90_ms: torch.Tensor      # long+xlong (paper Table 4)
    global_p95_ms: torch.Tensor
    global_std_ms: torch.Tensor
    completion_rate: torch.Tensor
    satisfaction: torch.Tensor
    goodput_rps: torch.Tensor
    makespan_ms: torch.Tensor
    n_rejects: torch.Tensor
    n_defer_events: torch.Tensor
    n_abandoned: torch.Tensor
    mean_severity_proxy: torch.Tensor
    class_p95_ms: torch.Tensor           # (K,) completed-latency P95
    class_completion_rate: torch.Tensor  # (K,) over the accepted set
    class_satisfaction: torch.Tensor     # (K,) deadline-met fraction
    class_goodput_rps: torch.Tensor      # (K,) met requests / makespan
    class_n_requests: torch.Tensor       # (K,) int32 offered per class


def compute_metrics(batch: RequestBatch, final: SimState,
                    n_classes: int | None = None) -> SimMetrics:
    if n_classes is None:
        n_classes = final.sched.deficit.shape[-1]
    req = final.req
    done = (req.status == COMPLETED) & batch.valid
    latency = req.finish_ms - batch.arrival_ms
    # rejected work is client-declared shedding: rates are over the
    # accepted set, with the reject count carried alongside
    rejected = (req.status == REJECTED) & batch.valid
    n_accepted = (batch.valid & ~rejected).sum()
    met = done & (req.finish_ms <= batch.arrival_ms + batch.deadline_budget_ms)
    n_met = met.sum()

    first_arrival = torch.min(torch.where(batch.valid, batch.arrival_ms,
                                          float("inf")))
    last_finish = torch.max(torch.where(done, req.finish_ms, float("-inf")))
    makespan = torch.clamp(last_finish - first_arrival, min=1.0)
    # a device-tensor divisor: CUDA divides by a host scalar as a
    # reciprocal multiply, which would round differently from the CPU
    makespan_s = makespan / torch.full_like(makespan, 1000.0)

    glob_lat = torch.where(done, latency, float("nan"))
    glob_mean = torch.nanmean(glob_lat)
    glob_std = torch.sqrt(torch.nanmean((glob_lat - glob_mean) ** 2))

    cls = torch.clamp(batch.cls, 0, n_classes - 1)
    cls_kn = (cls[None, :] == torch.arange(
        n_classes, dtype=torch.int32, device=cls.device)[:, None]
    ) & batch.valid[None, :]
    done_kn = cls_kn & done[None, :]
    accepted_k = (cls_kn & ~rejected[None, :]).sum(dim=1)
    met_k = (cls_kn & met[None, :]).sum(dim=1)
    one = torch.ones_like(n_accepted)

    return SimMetrics(
        short_p95_ms=masked_percentile(latency, done & (batch.bucket == SHORT),
                                       0.95),
        short_p90_ms=masked_percentile(latency, done & (batch.bucket == SHORT),
                                       0.90),
        long_p90_ms=masked_percentile(latency, done & (batch.bucket >= 2),
                                      0.90),
        global_p95_ms=masked_percentile(latency, done, 0.95),
        global_std_ms=glob_std,
        completion_rate=done.sum() / torch.maximum(n_accepted, one),
        satisfaction=n_met / torch.maximum(n_accepted, one),
        goodput_rps=n_met / makespan_s,
        makespan_ms=makespan,
        n_rejects=rejected.sum(),
        n_defer_events=torch.where(batch.valid, req.n_defers, 0).sum(),
        n_abandoned=((req.status == ABANDONED) & batch.valid).sum(),
        mean_severity_proxy=final.sched.ema_latency_ratio,
        class_p95_ms=torch.stack([masked_percentile(latency, m, 0.95)
                                  for m in done_kn]),
        class_completion_rate=done_kn.sum(dim=1) / torch.clamp(accepted_k,
                                                               min=1),
        class_satisfaction=met_k / torch.clamp(accepted_k, min=1),
        class_goodput_rps=met_k / makespan_s,
        class_n_requests=cls_kn.sum(dim=1).to(torch.int32),
    )


class PhaseMetrics(NamedTuple):
    """Per-phase joint metrics of a scenario run (leading axis = phase).
    A request belongs to the phase its arrival falls in (arrivals past
    the last edge go to the last phase).  Counts are over offered
    requests; rates are over the phase's accepted set.  An empty phase
    (or phase x class) has NaN percentiles."""

    phase_start_ms: torch.Tensor      # (P,) float32 window left edges
    n_arrived: torch.Tensor           # (P,) int32 offered per phase
    n_completed: torch.Tensor         # (P,) int32
    n_abandoned: torch.Tensor         # (P,) int32 implicit failures
    n_throttled: torch.Tensor         # (P,) int32 provider 429 bounces
    shed_by_bucket: torch.Tensor      # (P, 4) int32 rejects per ladder rung
    satisfaction: torch.Tensor        # (P,) float32 deadline-met / accepted
    p95_ms: torch.Tensor              # (P,) float32 completed-latency P95
    class_p95_ms: torch.Tensor        # (P, K) float32
    class_satisfaction: torch.Tensor  # (P, K) float32


def compute_phase_metrics(batch: RequestBatch, final: SimState,
                          edges_ms: torch.Tensor,
                          n_classes: int | None = None) -> PhaseMetrics:
    """Windowed metrics over the (P+1,) phase boundaries `edges_ms`."""
    if n_classes is None:
        n_classes = final.sched.deficit.shape[-1]
    dev = batch.arrival_ms.device
    edges_ms = edges_ms.to(dev)
    n_phases = edges_ms.shape[0] - 1
    i32 = torch.int32
    req = final.req
    done = (req.status == COMPLETED) & batch.valid
    rejected = (req.status == REJECTED) & batch.valid
    abandoned = (req.status == ABANDONED) & batch.valid
    latency = req.finish_ms - batch.arrival_ms
    met = done & (req.finish_ms <= batch.arrival_ms + batch.deadline_budget_ms)

    phase = torch.clamp(
        torch.searchsorted(edges_ms, batch.arrival_ms, right=True) - 1,
        0, n_phases - 1)
    in_p = (phase[None, :] == torch.arange(n_phases, device=dev)[:, None]
            ) & batch.valid[None, :]                               # (P, N)
    cls = torch.clamp(batch.cls, 0, n_classes - 1)
    cls_kn = cls[None, :] == torch.arange(n_classes, dtype=i32,
                                          device=dev)[:, None]     # (K, N)
    in_pk = in_p[:, None, :] & cls_kn[None, :, :]                  # (P, K, N)
    accepted_p = torch.clamp((in_p & ~rejected[None, :]).sum(dim=1), min=1)
    accepted_pk = torch.clamp((in_pk & ~rejected[None, None, :]).sum(dim=2),
                              min=1)
    done_p = in_p & done[None, :]
    done_pk = in_pk & done[None, None, :]
    bucket_oh = batch.bucket[None, :] == torch.arange(
        4, dtype=i32, device=dev)[:, None]                         # (4, N)
    shed = (in_p[:, None, :] & bucket_oh[None, :, :]
            & rejected[None, None, :]).sum(dim=2)

    return PhaseMetrics(
        phase_start_ms=edges_ms[:-1],
        n_arrived=in_p.sum(dim=1, dtype=i32),
        n_completed=done_p.sum(dim=1, dtype=i32),
        n_abandoned=(in_p & abandoned[None, :]).sum(dim=1, dtype=i32),
        n_throttled=torch.where(in_p, req.n_throttles[None, :], 0).sum(
            dim=1, dtype=i32),
        shed_by_bucket=shed.to(i32),
        satisfaction=(in_p & met[None, :]).sum(dim=1) / accepted_p,
        p95_ms=torch.stack([masked_percentile(latency, m, 0.95)
                            for m in done_p]),
        class_p95_ms=torch.stack([
            torch.stack([masked_percentile(latency, m, 0.95) for m in row])
            for row in done_pk]),
        class_satisfaction=(in_pk & met[None, None, :]).sum(dim=2)
        / accepted_pk,
    )
