"""`ttft_p95_ms`: the 95th percentile (nearest rank) of every request's
time to first token over the window's calls, in ms.  A request's time is
its call's, from the call's start to its first token on the host.  The
median goes to standard error with the sample's size."""
import math


def read(run):
    ttft = sorted(r["ttft_s"] for r in run.calls if "ttft_s" in r
                  for _ in range(r["batch"]))
    if not ttft:
        return None
    n = len(ttft)
    run.notes.append(f"ttft median {ttft[(n - 1) // 2] * 1e3!r} ms, "
                     f"{n} requests, {n - math.ceil(0.95 * n)} beyond p95")
    return ttft[math.ceil(0.95 * n) - 1] * 1e3
