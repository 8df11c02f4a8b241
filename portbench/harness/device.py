"""The yardstick's device arithmetic: the data-sheet peaks of one H100,
the roofline bound of a piece of work, and the reading of a
`torch.profiler` trace (device busy time, time by kernel name, idle
gaps by what the host was doing).

`bound` and the peaks are copies of `chip_smoke.py`'s.  The trace is
read as `chip_smoke.py`'s `device_activity` reads it, straight from the
profile's events, with what a window needs besides: busy time as the
union of the device's intervals (`device_activity` sums them, and two
kernels that overlap, as the flash-decode combine launched as a
programmatic dependent may, would count twice) and the harness's own
annotations (`torch.profiler.record_function`) to cut the window into
calls.
"""
from __future__ import annotations

import bisect
import dataclasses

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_OPS_PER_S = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the harness's annotations in a traced window
WINDOW = "portbench.window"
CALL = "portbench.call"


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_BF16_OPS_PER_S) -> tuple[float, str]:
    """(least seconds the chip could take, which peak sets it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Trace:
    """A traced window: device operations and host events as (start ns,
    end ns, name), each sorted by start, and the window's and calls'
    spans from the harness's annotations."""
    device: list
    host: list
    window: tuple
    calls: list

    def device_in(self, t0: int, t1: int) -> list:
        """Device operations that start inside [t0, t1)."""
        i = bisect.bisect_left(self.device, (t0,))
        j = bisect.bisect_left(self.device, (t1,))
        return self.device[i:j]


def collect(torch, prof) -> Trace:
    """Read a finished profile's events once."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window, calls = [], [], None, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name in (WINDOW, CALL):
                continue  # the annotations' device-side copies
            if t1 > t0:
                dev.append((t0, t1, name))
        elif name == WINDOW:
            window = (t0, t1)
        elif name == CALL:
            calls.append((t0, t1))
        else:
            host.append((t0, t1, name))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    dev.sort()
    host.sort()
    calls.sort()
    return Trace(dev, host, window, calls)


def union_ns(intervals) -> int:
    """Length of the union of (start, end, ...) intervals sorted by
    start."""
    total, cur0, cur1 = 0, None, None
    for iv in intervals:
        a, b = iv[0], iv[1]
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        elif b > cur1:
            cur1 = b
    if cur1 is not None:
        total += cur1 - cur0
    return total


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which an operation ran on the device."""
    w0, w1 = trace.window
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in trace.device
               if b > w0 and a < w1]
    return union_ns(clipped) / 1e9


def window_s(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) / 1e9


def time_by_name(trace: Trace) -> dict:
    """Seconds of device time in the window by operation name."""
    w0, w1 = trace.window
    out = {}
    for a, b, name in trace.device:
        if b > w0 and a < w1:
            out[name] = out.get(name, 0.0) + (min(b, w1) - max(a, w0)) / 1e9
    return out


def idle_gaps(trace: Trace, top: int = 10, scan: int = 4000) -> list:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle (the innermost host event covering it;
    "harness, between calls" outside every call, "host, outside any
    op" inside a call with no op open), largest first."""
    w0, w1 = trace.window
    busy, cur = [], None
    for a, b, _ in trace.device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            if cur is not None:
                busy.append(cur)
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy.append(cur)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    starts = [h[0] for h in trace.host]
    call_starts = [c[0] for c in trace.calls]
    out = {}
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(call_starts, mid) - 1
        if k < 0 or trace.calls[k][1] < mid:
            name = "harness, between calls"
        else:
            name = "host, outside any op"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - scan), -1):
                h = trace.host[j]
                if h[1] >= mid:
                    name = h[2]
                    break
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


# the flash-decode kernel's first launch opens a call's decode steps
DECODE_KERNEL = "decode_partial"


def call_spans(trace: Trace, opens: str | None = None) -> list:
    """Seconds of each call on the device: from its first device
    operation to the end of its last, of those that start inside the
    call's annotation.  With `opens`, from the first operation whose
    name holds it instead (a call's decode steps open at its first
    `DECODE_KERNEL`: its prefill, and the part of its first step before
    that kernel, left out).  A call with no such operation has no
    span."""
    out = []
    for a, b in trace.calls:
        ops = trace.device_in(a, b)
        if opens is not None:
            ops = ops[next((i for i, e in enumerate(ops) if opens in e[2]),
                           len(ops)):]
        if ops:
            out.append((max(e[1] for e in ops) - ops[0][0]) / 1e9)
    return out
