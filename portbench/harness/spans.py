"""The program's own spans and counters (`repro_torch.tracing`) over a
traced window.

A span is a host event of the profile (a profiler range the port opens
by name), so it is read from the trace: it belongs to the call whose
`portbench.call` annotation holds it, and its device time is the busy
union of the device operations launched inside it, the device's idle
inside it left out.

The trace keeps no link from a launch to its operation, so the link is
made by order and kind: the port runs on one stream, where the device
runs operations in the order the host launched them, and the device is
idle when the profiler starts.  The launches (CUDA runtime or driver
calls that put one operation on the device: `cudaLaunchKernel`,
`cuLaunchKernelEx`, `cudaMemcpyAsync`, `cudaMemsetAsync`, ...) of one
kind (a kernel, a copy or a memset) pair with the device's operations
of that kind in order, the last with the last.  No time is compared
across the two clocks, and kinds are paired apart, because on an H100
the device's timestamps part from the host's by up to 4 ms for seconds
at a time, and now and then misplace a memset or a kernel among its
neighbours; and from the end, because the profiler loses the records of
a few operations as it starts (13 kernels of a decode window's first
call).  Against the profile's own correlation ids this pairs all but 94
of 618,647 launches of a prefill window and 13 of 496,838 of a decode
window, each a neighbour's, and the span metrics read as the ids give
them to 0.002%.

Everything here returns None where there is nothing to read: an
untraced run, a run off the card where device time is asked for, a
profile whose launches and operations do not pair up, or a checkout
whose port keeps no spans.
"""
from __future__ import annotations

import bisect

from portbench.harness.device import union_ns

# what names a call that puts one operation on the device
LAUNCH = ("LaunchKernel", "Memcpy", "Memset")
# launches of one kind a profile may hold beyond its operations of that
# kind: records the profiler lost as it started
LOST = 64


def is_launch(name: str) -> bool:
    return name.startswith("cu") and any(k in name for k in LAUNCH)


def by_call(run, name: str) -> list | None:
    """The window's `name` spans, (start ns, end ns) on the profile's
    clock, one list a call of `run.calls`, in order."""
    tr = run.trace
    if tr is None or len(tr.calls) != len(run.calls):
        return None
    starts = [a for a, _ in tr.calls]
    out = [[] for _ in tr.calls]
    for a, b, n in tr.host:
        if n != name:
            continue
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and b <= tr.calls[k][1]:
            out[k].append((a, b))
    return out


def kind(name: str) -> str:
    """A device operation's kind, or the kind a launch call makes."""
    for k in ("Memcpy", "Memset"):
        if name.startswith(k) or (name.startswith("cu") and k in name):
            return k
    return "kernel"


def paired(trace) -> list | None:
    """(start ns of the launch, its device operation or None) for every
    launch of the profile, in order."""
    launched = [(a, n) for a, _, n in trace.host if is_launch(n)]
    ops: dict = {}
    for op in trace.device:
        ops.setdefault(kind(op[2]), []).append(op)
    kinds = [kind(n) for _, n in launched]
    made = [None] * len(launched)
    for k in set(kinds) | set(ops):
        mine = [i for i, x in enumerate(kinds) if x == k]
        got = ops.get(k, [])
        if not 0 <= len(mine) - len(got) <= LOST:
            return None
        for i, op in zip(reversed(mine), reversed(got)):
            made[i] = op
    return [(a, op) for (a, _), op in zip(launched, made)]


def device_ms(run, spans: list) -> list | None:
    """The device ms of each span of `spans` (one list a call, as
    `by_call` gives them), in the same shape: the busy union of the
    operations launched inside it."""
    tr = run.trace
    if tr is None or run.device.type != "cuda":
        return None
    pairs = paired(tr)
    if pairs is None:
        return None
    starts = [a for a, _ in pairs]
    out = []
    for held in spans:
        ms = []
        for h0, h1 in held:
            i = bisect.bisect_left(starts, h0)
            j = bisect.bisect_left(starts, h1)
            made = sorted(op for _, op in pairs[i:j] if op is not None)
            ms.append(union_ns(made) / 1e6)
        out.append(ms)
    return out


def decode_steps(run) -> list | None:
    """Each `generate` call's `model.decode_step` spans, when every call
    holds its `n_new - 1`."""
    steps = by_call(run, "model.decode_step")
    if (steps is None or not run.calls
            or [len(c) for c in steps]
            != [r.get("n_new", 0) - 1 for r in run.calls]):
        return None
    return steps


def step_counters(step: str) -> dict | None:
    """The port's counters of the model step `step` since they were
    last reset ({} when it counted nothing); None for a port without
    them."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.counters().get(step, {})


def device_ms_a_call(run, name: str) -> float | None:
    """The mean over whole cycles of a `prefill` cell's calls (the
    cycle's every length once each) of the device ms of a call's `name`
    spans, one a layer."""
    if run.wl["traffic"] != "prefill":
        return None
    per = by_call(run, name)
    L, cycle = run.c["num_hidden_layers"], run.params["cycle"]
    n = len(run.calls) // cycle * cycle
    if per is None or n == 0 or any(len(c) != L for c in per[:n]):
        return None
    ms = device_ms(run, per[:n])
    if ms is None:
        return None
    return sum(map(sum, ms)) / n
