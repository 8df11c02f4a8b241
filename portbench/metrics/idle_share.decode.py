"""`idle_share.decode`: the share of the traced window in which no
operation ran on the device, in a cell of `generate` traffic."""
from portbench.harness.device import busy_s, window_s


def read(run):
    if run.trace is None or run.wl["traffic"] != "generate":
        return None
    return 100.0 * (1.0 - busy_s(run.trace) / window_s(run.trace))
