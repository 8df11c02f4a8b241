"""Plain PyTorch versions of the three scheduler scoring kernels.

Counterparts of `repro.kernels.sched_score.ref`'s oracles, written to
give the same bits as the CUDA kernels in `sched_score.cu`:

* the score is `((w1*(wait/c) - w2*(c/ref)) + w3*urg) - w_route*route`
  with `c = max(cost, 1)`, one IEEE-rounded operation at a time (eager
  PyTorch fuses nothing, and the kernel is built with `-fmad=false`);
* masked lanes score NEG = -1e30, as in the kernel (the reference's jnp
  ordering path uses -inf for masked FIFO lanes instead);
* -0.0 is returned as +0.0, because the kernel ranks ±0 as one value
  and returns the canonical one;
* ranking is a stable descending sort: ties go to the lowest index,
  `lax.top_k`'s first-occurrence order.

`ops.py` calls these for tensors on the CPU; the tests and
`chip_smoke.py` hold the kernels against them.
`sched_score_topb_split_ref` and `sched_compact_topb_split_ref` follow
the CUDA kernels' partition (each CTA tile ranks its own lanes, then the
tiles' lists are merged), for the tests to show that the partition
changes no bit.
"""
from __future__ import annotations

import torch

NEG = -1e30


def scores_ref(wait, cost, urgency, mask, weights, route=None):
    """Masked paper score per lane (NEG where `mask` is False)."""
    c = torch.clamp(cost, min=1.0)
    score = weights[0] * (wait / c) - weights[1] * (c / weights[3])
    score = score + weights[2] * urgency
    if route is not None:
        score = score - weights[4] * route
    score = torch.where(mask, score, NEG)
    return torch.where(score == 0, 0.0, score)


def _rank(score, b: int):
    order = torch.sort(score, descending=True, stable=True).indices[:b]
    return order.to(torch.int32), score[order]


def sched_score_topb_ref(wait, cost, urgency, mask, weights, b: int,
                         route=None):
    """Top-b `(idx (b,) int32, score (b,) float32)`, best first."""
    return _rank(scores_ref(wait, cost, urgency, mask, weights, route), b)


def sched_score_topb_split_ref(wait, cost, urgency, mask, weights, b: int,
                               route=None, *, tile: int):
    """`sched_score_topb_ref` computed as the kernel partitions it: each
    tile of `tile` lanes (one CTA) keeps its best L = b rounded up to a
    power of two, ranked as above; the lists, in tile order, are ranked
    again and the best b returned.  A stable sort of the lists keeps
    equal scores in index order, so ties still go to the lowest
    index."""
    score = scores_ref(wait, cost, urgency, mask, weights, route)
    keep = 1 << (b - 1).bit_length()
    idx, val = [], []
    for start in range(0, score.shape[0], tile):
        part = score[start:start + tile]
        i, s = _rank(part, min(keep, part.shape[0]))
        idx.append(i + start)
        val.append(s)
    j, s = _rank(torch.cat(val), b)
    return torch.cat(idx)[j.long()], s


def sched_score_argmax_ref(wait, cost, urgency, mask, weights, route=None):
    """Masked argmax, first occurrence: `(idx () int32, score ())`."""
    score = scores_ref(wait, cost, urgency, mask, weights, route)
    i = torch.argmax(score)
    return i.to(torch.int32), score[i]


def _compact(values, target, fill, w: int):
    out = torch.full((w + 1,), fill, dtype=values.dtype, device=values.device)
    out[target] = values  # dead slots all land on the spare slot w
    return out[:w]


def compact_pool_ref(slot_req, alive, wait, cost, urgency, route=None):
    """The two-pass path's compaction (cumsum + scatter): (compacted ids
    (w,) int32 with -1 tail, n_live () int32, mask = index < n_live,
    and the compacted wait, cost, urgency and route)."""
    w = slot_req.shape[0]
    pos = torch.cumsum(alive, 0, dtype=torch.int32) - 1
    target = torch.where(alive, pos, w).long()
    creq = _compact(slot_req.to(torch.int32), target, -1, w)
    cwait = _compact(wait, target, 0.0, w)
    ccost = _compact(cost, target, 1.0, w)
    curg = _compact(urgency, target, 0.0, w)
    croute = None if route is None else _compact(route, target, 0.0, w)
    n_live = alive.sum(dtype=torch.int32)
    mask = torch.arange(w, device=alive.device) < n_live
    return creq, n_live, mask, cwait, ccost, curg, croute


def sched_compact_topb_ref(slot_req, alive, wait, cost, urgency, weights,
                           b: int, route=None):
    """Stable compaction of the slot pool, then the top-b ranking over
    the compacted pool with mask = index < n_live.  Returns (compacted
    (w,) int32 with -1 tail, n_live () int32, idx (b,) int32 in
    compacted coordinates, score (b,) float32)."""
    creq, n_live, mask, cwait, ccost, curg, croute = compact_pool_ref(
        slot_req, alive, wait, cost, urgency, route)
    idx, score = sched_score_topb_ref(cwait, ccost, curg, mask, weights, b,
                                      croute)
    return creq, n_live, idx, score


def sched_compact_topb_split_ref(slot_req, alive, wait, cost, urgency,
                                 weights, b: int, route=None, *, tile: int):
    """`sched_compact_topb_ref` computed as the kernel partitions it: the
    live slots of each tile of `tile` slots, the exclusive prefix of those
    counts, each tile's ids at their compacted positions and its best L
    (b rounded up to a power of two) live slots ranked by compacted
    position; then the lists, in tile order, with the sentinel keys
    (NEG at positions n_live .. min(w, n_live + L) - 1) after them,
    ranked again.  Lists in tile order and sentinels last keep equal
    scores in compacted order, so ties still go to the lowest index."""
    w = slot_req.shape[0]
    score = scores_ref(wait, cost, urgency, alive, weights, route)
    keep = 1 << (b - 1).bit_length()
    creq = torch.full((w,), -1, dtype=torch.int32, device=slot_req.device)
    idx, val = [], []
    excl = 0
    for start in range(0, w, tile):
        live = alive[start:start + tile]
        pos = excl + torch.cumsum(live, 0, dtype=torch.int32)[live] - 1
        creq[pos.long()] = slot_req[start:start + tile][live].to(torch.int32)
        part = score[start:start + tile][live]
        i, s = _rank(part, min(keep, part.shape[0]))
        idx.append(pos[i.long()])
        val.append(s)
        excl += int(live.sum())
    n_tail = max(0, min(w, excl + keep) - excl)
    idx.append(torch.arange(excl, excl + n_tail, dtype=torch.int32,
                            device=slot_req.device))
    val.append(torch.full((n_tail,), NEG, dtype=score.dtype,
                          device=score.device))
    j, s = _rank(torch.cat(val), b)
    n_live = torch.tensor(excl, dtype=torch.int32, device=slot_req.device)
    return creq, n_live, torch.cat(idx)[j.long()], s
