"""Public wrappers of the scheduler scoring kernels.

Counterpart of `repro.kernels.sched_score.ops`.  Each wrapper refuses
inputs that need a gradient (the kernels are forward-only), checks
device, dtype, shape and contiguity, then dispatches on where its
tensors lie:

* on CUDA it launches the hand kernel from `sched_score.cu` on the
  current stream (outputs allocated here with `torch.empty`; the
  kernels' workspace once per device, `_workspace`), raises if the
  launch reports an error, and adds one to its count in `LAUNCHES`;
* on the CPU it calls the plain version in `ref.py`;
* anywhere else it raises.

No path falls back: a build or launch failure is an exception.  The
reference's padding of the queue to a multiple of 128 lanes is a TPU
tiling need; the CUDA kernels mask their ragged edge themselves.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sched_score import ref

TILE = 4096   # lanes (slots) per CTA of every kernel (sched_score.cu TILE)
BMAX = 128    # largest b, as in the reference

LAUNCHES = {"sched_score_topb": 0, "sched_score_argmax": 0,
            "sched_compact_topb": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sched_score_topb": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "sched_score_argmax": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "sched_compact_topb": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                           _P, _P, _P, _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures bound (once)."""
    global _LIB
    with _build.LOCK:
        if _LIB is None:
            lib = _build.load("sched_score", {**_SIGNATURES,
                                              "sched_score_tile": []})
            if lib.sched_score_tile() != TILE:
                raise RuntimeError("sched_score.cu TILE disagrees with "
                                   "ops.TILE")
            _LIB = lib
    return _LIB


def _check(name, tensors, dtypes, n):
    _build.refuse_autograd(name, *tensors)
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.shape != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_weights(name, weights, route, dev):
    _build.refuse_autograd(name, weights)
    nf = 4 if route is None else 5
    if weights.shape != (nf,) or weights.dtype != torch.float32:
        raise ValueError(f"{name}: weights must be ({nf},) float32, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    if weights.device != dev or not weights.is_contiguous():
        raise ValueError(f"{name}: weights must be contiguous on {dev}")


def _features(name, wait, cost, urgency, mask, weights, route):
    n = wait.shape[0]
    ts = [wait, cost, urgency, mask] + ([] if route is None else [route])
    dts = [torch.float32] * 3 + [torch.bool] + (
        [] if route is None else [torch.float32])
    dev = _check(name, ts, dts, n)
    _check_weights(name, weights, route, dev)
    return n, dev


_WORKSPACE: dict[torch.device, tuple[torch.Tensor, ...]] = {}


def _workspace(n: int, dev):
    """The (keys, counters, status) workspace of a call over n lanes.

    Past one tile each CTA writes its best keys (at most BMAX) to
    `keys`, and counts itself in on a done counter (`counters[0]` for
    top-b and argmax, `counters[1]` for compaction); the last CTA to
    arrive merges them and sets it back to 0.  Compaction also takes its
    tiles from a ticket (`counters[2]`), which the last CTA sets back to
    0, and publishes each tile's live count in a status word tagged with
    an epoch (`counters[3]`) that the last CTA advances, so the words of
    an earlier call never read as this call's.  So all three are made
    once per device (`counters` and `status` zeroed then; `keys` and
    `status` grown when a longer queue comes), not on every call, and a
    call launches one kernel.  One workspace serves one stream at a
    time: calls in flight on two streams at once would share the
    counters."""
    tiles = -(-n // TILE)
    keys, counters, status = _WORKSPACE.get(dev, (None, None, None))
    if counters is None:
        counters = torch.zeros((4,), dtype=torch.int32, device=dev)
    if keys is None or keys.numel() < tiles * BMAX:
        keys = torch.empty((tiles * BMAX,), dtype=torch.int64, device=dev)
    if status is None or status.numel() < tiles:
        status = torch.zeros((tiles,), dtype=torch.int64, device=dev)
    _WORKSPACE[dev] = (keys, counters, status)
    return keys, counters, status


def _compact_workspace(w: int, dev):
    """Compaction's (keys, counters, status): its done counter, ticket
    and epoch are `counters[1:]`."""
    keys, counters, status = _workspace(w, dev)
    return keys, counters[1:], status


def _ptr(t):
    return None if t is None else t.data_ptr()


def sched_score_topb(wait, cost, urgency, mask, weights, b: int, route=None):
    """Fused score + top-b over a queue of any length n >= 1.

    wait/cost/urgency (and route): (n,) float32; mask: (n,) bool;
    weights: (4,) [w_wait, w_size, w_urg, ref_tokens], or (5,) with
    w_route when `route` is given.  Returns (idx (b,) int32, score (b,)
    float32) best first, ties to the lowest index; b is cut to n."""
    n, dev = _features("sched_score_topb", wait, cost, urgency, mask,
                       weights, route)
    b = min(int(b), n)
    if not 1 <= b <= BMAX:
        raise ValueError(f"sched_score_topb: need 1 <= b <= {BMAX}, got {b}")
    if dev.type == "cpu":
        return ref.sched_score_topb_ref(wait, cost, urgency, mask, weights, b,
                                        route)
    lib = _lib()
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    keys, done, _ = _workspace(n, dev)
    rc = lib.sched_score_topb(
        _ptr(wait), _ptr(cost), _ptr(urgency), _ptr(route), _ptr(mask),
        _ptr(weights), n, b, _ptr(keys), _ptr(done), _ptr(idx), _ptr(score),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "sched_score_topb")
    _build.count_launch(LAUNCHES, "sched_score_topb")
    return idx, score


def sched_score_argmax(wait, cost, urgency, mask, weights, route=None):
    """Fused score + masked argmax (first occurrence).  Returns
    (idx () int32, score () float32)."""
    n, dev = _features("sched_score_argmax", wait, cost, urgency, mask,
                       weights, route)
    if dev.type == "cpu":
        return ref.sched_score_argmax_ref(wait, cost, urgency, mask, weights,
                                          route)
    lib = _lib()
    idx = torch.empty((), dtype=torch.int32, device=dev)
    score = torch.empty((), dtype=torch.float32, device=dev)
    keys, done, _ = _workspace(n, dev)
    rc = lib.sched_score_argmax(
        _ptr(wait), _ptr(cost), _ptr(urgency), _ptr(route), _ptr(mask),
        _ptr(weights), n, _ptr(keys), _ptr(done), _ptr(idx), _ptr(score),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "sched_score_argmax")
    _build.count_launch(LAUNCHES, "sched_score_argmax")
    return idx, score


def sched_compact_topb(slot_req, alive, wait, cost, urgency, weights, b: int,
                       route=None):
    """Fused stable compaction + score + top-b over a slot pool of any
    width w >= 1.

    slot_req: (w,) int32 request ids in slot order; alive: (w,) bool;
    wait/cost/urgency (and route): (w,) float32 per slot, pre-compaction.
    Returns (compacted (w,) int32 with -1 tail, n_live () int32, idx
    (b,) int32 in compacted coordinates, score (b,) float32), ranked as
    the top-b of the compacted pool with lanes n_live .. w-1 at NEG
    (`ref.sched_compact_topb_ref`)."""
    w = slot_req.shape[0]
    ts = [slot_req, alive, wait, cost, urgency] + (
        [] if route is None else [route])
    dts = [torch.int32, torch.bool] + [torch.float32] * (
        3 if route is None else 4)
    dev = _check("sched_compact_topb", ts, dts, w)
    _check_weights("sched_compact_topb", weights, route, dev)
    b = min(int(b), w)
    if not 1 <= b <= BMAX:
        raise ValueError(f"sched_compact_topb: need 1 <= b <= {BMAX}, "
                         f"got {b}")
    if dev.type == "cpu":
        return ref.sched_compact_topb_ref(slot_req, alive, wait, cost,
                                          urgency, weights, b, route)
    lib = _lib()
    out_req = torch.empty((w,), dtype=torch.int32, device=dev)
    n_live = torch.empty((), dtype=torch.int32, device=dev)
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    keys, counters, status = _compact_workspace(w, dev)
    rc = lib.sched_compact_topb(
        _ptr(slot_req), _ptr(alive), _ptr(wait), _ptr(cost), _ptr(urgency),
        _ptr(route), _ptr(weights), w, b, _ptr(keys), _ptr(counters),
        _ptr(status), _ptr(out_req), _ptr(n_live), _ptr(idx), _ptr(score),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_rc(lib, rc, "sched_compact_topb")
    _build.count_launch(LAUNCHES, "sched_compact_topb")
    return out_req, n_live, idx, score
