"""Layer 2 — intra-class ordering (paper §3.1.2), K classes.

Counterpart of `repro.core.ordering`.  Among eligible requests, score
each candidate with the paper's slowdown-aware rule

    score = w1 * (wait / cost) - w2 * (size / ref) + w3 * urgency

and release the best; a class orders FIFO or scored by the policy bit
`ord_scored`.  `select_top_b` ranks the top B releases of every class,
the feed of `scheduler.schedule_batch`.

Two backends:

* "torch" (the reference's "jnp"): `order_scores` and a stable
  descending sort, ties to the lowest index like `lax.top_k`
  (`torch.topk` promises no tie order, so it is not used);
* "kernel" (the reference's "pallas"): the fused score + top-B kernel
  of `kernels/sched_score`, one launch per class plus one for the global
  FIFO lane.  FIFO rides the same kernel with weights [1, 0, 0, 1], unit
  cost and -arrival_ms as `wait`, so its score is exactly -arrival_ms.

Masked lanes score NEG on the kernel path and -inf (FIFO) on the torch
path; both rank after every eligible lane in index order.

In fleet mode `route` ((N,) float32, `routing.route_requests`) is each
request's predicted completion cost at its best endpoint, in seconds.
Scored classes subtract it as a fourth term, after the base sum; on the
kernel path it streams as the fifth feature row, which the FIFO weight
row zeroes, so FIFO ranking never sees it.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import pinned
from repro_torch.core.policy import PolicyConfig, n_classes
from repro_torch.core.types import RequestBatch
from repro_torch.kernels.sched_score.ops import sched_score_topb

_NEG = -1e30

BACKENDS = ("torch", "kernel")


def eligibility(batch: RequestBatch, status, defer_until, now_ms):
    """Feasible set: arrived, pending, not under defer backoff."""
    return (batch.valid & (status == 0) & (batch.arrival_ms <= now_ms)
            & (defer_until <= now_ms))


def _wait_and_urgency(batch: RequestBatch, now_ms):
    """Shared score features of both backends."""
    wait = torch.clamp(now_ms - batch.arrival_ms, min=0.0)
    deadline_abs = batch.arrival_ms + batch.deadline_budget_ms
    time_left = deadline_abs - now_ms
    urgency = torch.clamp(
        1.0 - time_left / torch.clamp(batch.deadline_budget_ms, min=1.0),
        0.0, 2.0)
    return wait, urgency


def order_scores(batch: RequestBatch, now_ms, cfg: PolicyConfig,
                 route=None):
    """Paper scoring rule over every request (mask applied by caller);
    each term rounds before the sum, in the kernel's association.  The
    fleet `route` term is subtracted last: `((t0 - t1) + t2) - t3`."""
    wait, urgency = _wait_and_urgency(batch, now_ms)
    cost = torch.clamp(batch.p50, min=1.0)
    terms = pinned((
        cfg.ord_w_wait * (wait / cost),
        cfg.ord_w_size * (cost / cfg.ord_ref_tokens),
        cfg.ord_w_urg * urgency,
    ))
    score = (terms[0] - terms[1]) + terms[2]
    if route is None:
        return score
    return score - pinned(cfg.ord_w_route * route)


def _rank_desc(x: torch.Tensor, b: int) -> torch.Tensor:
    """First b positions of a stable descending sort along the last axis
    (ties keep index order): `lax.top_k`'s ranking."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    return order[..., :b].to(torch.int32)


def _fifo_weights(device, with_route: bool = False) -> torch.Tensor:
    w = torch.zeros((5 if with_route else 4,), dtype=torch.float32,
                    device=device)
    w[0:4:3] = 1.0  # [1, 0, 0, 1(, 0)]: score == -arrival_ms exactly
    return w


def rank_fifo(batch: RequestBatch, mask, b: int, backend: str = "torch"):
    """Global FIFO ranked list: the first `b` eligible requests by
    arrival.  Returns ((L,) int32 indices, () int32 eligible count),
    L = min(b, N).  Feeds the naive (ignore-class) lane."""
    b = min(int(b), batch.n)
    n_elig = mask.sum(dtype=torch.int32)
    if backend == "kernel":
        arrival = batch.arrival_ms
        idx, _ = sched_score_topb(
            -arrival, torch.ones_like(arrival), torch.zeros_like(arrival),
            mask, _fifo_weights(arrival.device), b)
        return idx, n_elig
    if backend != "torch":
        raise ValueError(f"unknown ordering backend: {backend!r}")
    key = torch.where(mask, batch.arrival_ms, float("inf"))
    return _rank_desc(-key, b), n_elig


def _select_top_b_kernel(batch, cls_mask, now_ms, cfg, b: int, route=None):
    """(K, L) ranked candidates, one kernel launch per class.  With
    `route` the weight rows grow a fifth entry: `ord_w_route` for a
    scored class, 0 for FIFO."""
    wait, urgency = _wait_and_urgency(batch, now_ms)
    fifo_key = -batch.arrival_ms
    cost = batch.p50  # the kernel applies the max(cost, 1) clamp itself
    scored = [cfg.ord_w_wait, cfg.ord_w_size, cfg.ord_w_urg,
              cfg.ord_ref_tokens]
    if route is not None:
        scored.append(cfg.ord_w_route)
    w_scored = torch.stack(scored)
    w_fifo = _fifo_weights(wait.device, with_route=route is not None)
    rows = []
    for c in range(n_classes(cfg)):
        use_score = cfg.ord_scored[c] > 0
        idx, _ = sched_score_topb(
            torch.where(use_score, wait, fifo_key),
            torch.where(use_score, cost, 1.0),
            torch.where(use_score, urgency, 0.0),
            cls_mask[c], torch.where(use_score, w_scored, w_fifo), b, route)
        rows.append(idx)
    return torch.stack(rows)


def select_top_b(
    batch: RequestBatch,
    cls_mask: torch.Tensor,  # (K, N) bool — eligible requests per class
    now_ms,
    cfg: PolicyConfig,
    b: int,
    backend: str = "torch",
    route=None,
):
    """Ranked head-of-line candidates for every class, best first.

    Returns (idx, n_elig): (K, L) int32 ranked indices with L = min(b, N)
    and (K,) int32 eligible counts.  Only the first min(n_elig[c], L)
    entries of row c are meaningful.  `route` ((N,) float32 or None)
    adds the fleet route term to scored classes on both backends."""
    b = min(int(b), batch.n)
    n_elig = cls_mask.sum(dim=1, dtype=torch.int32)
    if backend == "kernel":
        return _select_top_b_kernel(batch, cls_mask, now_ms, cfg, b,
                                    route), n_elig
    if backend != "torch":
        raise ValueError(f"unknown ordering backend: {backend!r}")
    fifo_key = torch.where(cls_mask, batch.arrival_ms[None, :], float("inf"))
    scores = torch.where(
        cls_mask, order_scores(batch, now_ms, cfg, route)[None, :], _NEG)
    fifo_rank = _rank_desc(-fifo_key, b)   # (K, L) earliest first
    sc_rank = _rank_desc(scores, b)        # (K, L) best score first
    use_score = cfg.ord_scored[:, None] > 0
    return torch.where(use_score, sc_rank, fifo_rank), n_elig


def select_per_class(batch, cls_mask, now_ms, cfg, backend: str = "torch"):
    """Head-of-line pick per class: the b=1 column of `select_top_b`.
    Returns ((K,) int32 idx, (K,) bool any-eligible)."""
    idx, _ = select_top_b(batch, cls_mask, now_ms, cfg, 1, backend=backend)
    return idx[:, 0], cls_mask.any(dim=1)
