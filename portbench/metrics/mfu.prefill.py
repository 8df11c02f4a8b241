"""`mfu.prefill`: the model FLOPs of the traced window's prefills
(`count.<family>.prefill_flops`: dense products and causal attention)
over the calls' time on the device (`call_spans`: each call's first
device operation to the end of its last), as a share of the H100's 989
TFLOP/s (bf16)."""
from portbench.harness.device import PEAK_BF16_OPS_PER_S, call_spans


def read(run):
    calls = [r for r in run.calls if "ttft_s" in r]
    count = run.count
    if run.trace is None or not calls or not hasattr(count, "prefill_flops"):
        return None
    spans = call_spans(run.trace)
    if len(spans) != len(calls) or len(calls) != len(run.calls):
        return None
    flops = sum(count.prefill_flops(run.c, r["batch"], r["prompt_len"])
                for r in calls)
    return 100.0 * flops / sum(spans) / PEAK_BF16_OPS_PER_S
