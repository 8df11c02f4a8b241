"""`idle_share.prefill`: the share of the traced window in which no
operation ran on the device, in a cell of `prefill` traffic."""
from portbench.harness.device import busy_s, window_s


def read(run):
    if run.trace is None or run.wl["traffic"] != "prefill":
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / window_s(run.trace))
