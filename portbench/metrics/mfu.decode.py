"""`mfu.decode`: the useful FLOPs of the traced window's decode steps
(`count.<family>.decode_step_flops`: attention over the valid cache,
the dense MLP, the chosen experts, the head) over the steps' time, as a
share of 989 TFLOP/s.  A call's steps run on the device from its first
flash-decode kernel (`DECODE_KERNEL`) to the end of its last
operation."""
from portbench.harness.device import (
    DECODE_KERNEL,
    PEAK_BF16_OPS_PER_S,
    call_spans,
)


def read(run):
    count = run.count
    calls = [r for r in run.calls if "n_new" in r]
    if run.trace is None or not calls or not hasattr(count,
                                                      "decode_step_flops"):
        return None
    spans = call_spans(run.trace, DECODE_KERNEL)
    if len(spans) != len(calls):
        return None
    flops = sum(count.decode_step_flops(run.c, r["batch"], r["prompt_len"]
                                        + s + 1)
                for r in calls for s in range(r["n_new"] - 1))
    return 100.0 * flops / sum(spans) / PEAK_BF16_OPS_PER_S
