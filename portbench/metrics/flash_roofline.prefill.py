"""`flash_roofline.prefill`: the flash-attention kernel's share of its
roofline over the traced window's prefills: the sum of each call's
bound (per launch the larger of FLOPs / 989 TFLOP/s and bytes / 3.35
TB/s, from `count.<family>.flash_call`, one launch a layer) over the
device time of the kernels named in KERNELS."""
from portbench.harness.device import bound, time_by_name

KERNELS = ("flash_fwd_bf16",)


def read(run):
    calls = [r for r in run.calls if "ttft_s" in r]
    count = run.count
    if run.trace is None or not calls or not hasattr(count, "flash_call"):
        return None
    secs = sum(s for name, s in time_by_name(run.trace).items()
               if any(k in name for k in KERNELS))
    if secs <= 0:
        return None
    L = run.c["num_hidden_layers"]
    least = sum(L * bound(*reversed(count.flash_call(
        run.c, r["batch"], r["prompt_len"])))[0] for r in calls)
    return 100.0 * least / secs
