"""`expert_use.decode`: of the experts whose products the traced
window's decode steps computed (the port's `moe.experts_run` counter,
every expert in a dropless step), the share its tokens chose
(`moe.experts_chosen`: the distinct experts of each MoE call's slots),
summed over the steps and the layers."""
from portbench.harness.spans import decode_steps, step_counters


def read(run):
    if decode_steps(run) is None:
        return None
    got = step_counters("model.decode_step")
    if not got or not got.get("moe.experts_run"):
        return None
    return 100.0 * got.get("moe.experts_chosen", 0) / got["moe.experts_run"]
