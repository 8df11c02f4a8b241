"""`hbm_share.decode`: the bytes the traced window's decode steps need
(`count.<family>.decode_step_bytes`: the distinct experts each step's
tokens chose, the dense MLP, attention's weights and valid cache, the
norms, the head) over the steps' time, as a share of 3.35 TB/s.  The
experts each step chose are counted from its router's logits (the
`generate` driver's hooks); the steps' time as in `mfu.decode`."""
from portbench.harness.device import (
    DECODE_KERNEL,
    PEAK_BYTES_PER_S,
    call_spans,
)


def read(run):
    count = run.count
    calls = [r for r in run.calls if "experts_used" in r]
    if run.trace is None or not calls or not hasattr(count,
                                                      "decode_step_bytes"):
        return None
    spans = call_spans(run.trace, DECODE_KERNEL)
    if len(spans) != len(calls) or len(calls) != len(run.calls):
        return None
    n_bytes = sum(count.decode_step_bytes(run.c, r["batch"],
                                          r["prompt_len"] + s + 1, used)
                  for r in calls for s, used in enumerate(r["experts_used"]))
    return 100.0 * n_bytes / sum(spans) / PEAK_BYTES_PER_S
