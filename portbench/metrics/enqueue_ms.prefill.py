"""`enqueue_ms.prefill`: the median host ms of the traced window's
prefills, each the port's `model.prefill` span as the profile's host
events hold it (the clock the device trace shares): the time the host
takes to enqueue a call's model step on the card, which returns before
the device has done the work unless the launch queue is full.  Read
under the profiler, which slows the host."""
import statistics

PREFILL = "model.prefill"


def read(run):
    if (run.trace is None or run.device.type != "cuda"
            or any("ttft_s" not in r for r in run.calls)):
        return None
    w0, w1 = run.trace.window
    spans = [(a, b) for a, b, name in run.trace.host
             if name == PREFILL and w0 <= a and b <= w1]
    if not spans or len(spans) != len(run.calls):
        return None
    return statistics.median(b - a for a, b in spans) / 1e6
